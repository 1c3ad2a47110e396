"""Data parallelism: one process a GPU in a ``torch.distributed`` process
group, ``DistributedDataParallel`` over the port's models; the grid of data,
seq and model groups that sequence parallelism (parallel/sequence.py) and
tensor parallelism (parallel/tensor.py) run on.

Counterpart of efficientconformer_tpu/parallel/mesh.py's data axis
(``make_mesh``, ``globalize``, ``shard_batch``) and of the JAX runtime's
``jax.distributed.initialize`` and ``gather_strings`` (runtime.py:318-342),
in PyTorch's idiom, which is also the original repository's scheme (DDP
spawn, NCCL, synced BatchNorm, a sharded sampler; mesh.py:3-12):

- ``process_group`` sets up the group of one rank: NCCL on the card, gloo on
  the CPU, from ``torchrun``'s environment (``init_from_env``) or from the
  address a launcher hands its ranks; each rank runs on ``cuda:local_rank``
  or on the CPU when the caller asks for it.
- ``launch`` spawns N ranks of a function and returns what each returned.
  On the card it refuses more ranks than visible GPUs, unless the caller
  names ``backend="gloo"``, which lets ranks share a card.
- ``shard_batch`` takes a rank's slice of every microbatch of a global
  batch, ``gather_strings`` all-gathers each rank's list of strings, and
  ``check_same_parameters`` holds every rank to the same weights.
- ``all_reduce_sum`` is an all-reduce that autograd differentiates: its
  backward sums the incoming gradients over the ranks too (the global
  BatchNorm statistics of models/layers.py).
- ``make_grid(model_parallel, seq_parallel)`` splits the world into data,
  seq and model groups, the JAX mesh's ("data", "seq", "model") axes
  (mesh.py:23-53): seq between data and model, model innermost, rank =
  (data_idx * S + seq_idx) * M + model_idx, so a model group is M
  neighbouring ranks and a seq group S ranks M apart.
  ``data_rank``/``data_size``/``data_group``, ``seq_rank``/``seq_size``/
  ``seq_group`` and ``model_rank``/``model_size``/``model_group`` read it,
  and ``replica_group`` is the data x seq group of this rank's model index
  (DDP's gradient average, the time-sharded BatchNorm statistics). Without
  a grid the whole world is the data axis and the other axes have one rank,
  so data parallelism alone reads the same accessors. The data-parallel
  helpers (``shard_batch``, ``gather_strings``, ``sum_over_ranks``) work
  over the data axis: the ranks of one seq or model group take the same
  rows, as the JAX package's ``shard_batch`` shards over "data" alone
  (mesh.py:281-283).
- The sequence-parallel planners, copied from the JAX package's mesh.py
  :124-236 (``seq_frame_schedule``, ``sp_audio_lengths``, ``sp_coverage``,
  ``sp_pad_align``, ``sp_coverage_warn``): the frame count at each point
  where the encoder shards time, and the loader pad lengths at which every
  point divides by the seq size.
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
import pickle
import queue
import socket
import time
import traceback
from typing import Callable, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

# the variables torchrun sets for every rank it starts
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

_DEVICE: Optional[torch.device] = None   # this rank's device inside process_group


class Grid(NamedTuple):
    """This rank's place on the (data, seq, model) grid: its index and the
    size of each axis, and the process groups of its axes (None for an axis
    of one rank, whose collectives are the identity; the data group, or the
    replica group, None with more than one rank is the whole world).
    ``replica_group`` holds the data x seq ranks of this rank's model
    index."""

    data_rank: int
    data_size: int
    model_rank: int
    model_size: int
    data_group: Optional[object]
    model_group: Optional[object]
    seq_rank: int = 0
    seq_size: int = 1
    seq_group: Optional[object] = None
    replica_group: Optional[object] = None

    @property
    def replica_rank(self) -> int:
        """This rank's index in its replica group: data_rank * S + seq_rank."""
        return self.data_rank * self.seq_size + self.seq_rank

    @property
    def replica_size(self) -> int:
        return self.data_size * self.seq_size


_GRID: Optional[Grid] = None             # set by make_grid inside process_group


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    """Whether this process prints and writes: rank 0, or no group."""
    return rank() == 0


def device() -> Optional[torch.device]:
    """This rank's device inside ``process_group``, else None."""
    return _DEVICE if dist.is_initialized() else None


def torchrun_env() -> bool:
    """Whether torchrun started this process (its variables are all set)."""
    return all(v in os.environ for v in TORCHRUN_VARS)


def default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def check_world_size(world: int, device_type: str, backend: Optional[str] = None) -> None:
    """Refuse a group the machine cannot hold: on the card one rank a
    visible GPU, never more (NCCL refuses two ranks on one device, and the
    port does not move to the CPU on its own); ``backend="gloo"`` lets
    ranks share a card."""
    if world < 1:
        raise ValueError(f"world size {world}: at least one rank")
    if device_type != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --cpu (device 'cpu') to run the ranks on "
                           "the CPU over gloo")
    n = torch.cuda.device_count()
    if world > n and backend != "gloo":
        raise ValueError(f"world size {world} asks for {world} GPUs, but {n} "
                         f"{'is' if n == 1 else 'are'} visible: data parallelism runs one "
                         "rank a GPU (set --world_size to at most the GPU count)")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def process_group(rank_: int, world: int, device_type: str = "cuda",
                  backend: Optional[str] = None, init_method: Optional[str] = None,
                  local_rank: Optional[int] = None):
    """Inside it, this process is rank ``rank_`` of the default process
    group of ``world`` ranks; yields its device (``cuda:local_rank``, on a
    card shared modulo the GPU count when the backend is gloo, or the CPU).
    ``init_method`` is the group's address (``tcp://host:port`` or
    ``env://``); a group of one rank needs none. The group is destroyed on
    the way out."""
    global _DEVICE, _GRID
    backend = backend or default_backend(device_type)
    local_rank = rank_ if local_rank is None else local_rank
    if device_type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    if init_method is None and world == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    else:
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank_,
                                world_size=world)
    _DEVICE = dev
    try:
        yield dev
    finally:
        _DEVICE = _GRID = None
        dist.destroy_process_group()


def init_from_env(device_type: str = "cuda", backend: Optional[str] = None):
    """``process_group`` of a rank that torchrun started (the counterpart of
    ``ECF_MULTIHOST=1``'s ``jax.distributed.initialize``)."""
    world = int(os.environ["WORLD_SIZE"])
    check_world_size(int(os.environ.get("LOCAL_WORLD_SIZE", world)), device_type, backend)
    return process_group(int(os.environ["RANK"]), world, device_type, backend, "env://",
                         int(os.environ["LOCAL_RANK"]))


def check_model_parallel(world: int, model_parallel: int, seq_parallel: int = 1) -> None:
    """Refuse model and seq sizes whose product does not divide the world,
    with the JAX package's message (``make_mesh``, mesh.py:37-45)."""
    for name, n in (("model_parallel", model_parallel), ("seq_parallel", seq_parallel)):
        if n < 1:
            raise ValueError(f"{name}={n}: at least one rank")
    if world % (model_parallel * seq_parallel):
        raise ValueError(f"model_parallel={model_parallel} x seq_parallel={seq_parallel} does "
                         f"not divide the {world} visible device(s)")


def _groups(lists: list, r: int):
    """``dist.new_group`` of each rank list (every rank creates every group,
    in the same order, as it requires): the one holding rank ``r``, None
    for lists of one rank."""
    mine = None
    for ranks in lists:
        if len(ranks) < 2:
            continue
        g = dist.new_group(ranks)
        if r in ranks:
            mine = g
    return mine


def make_grid(model_parallel: int, seq_parallel: int = 1) -> Grid:
    """Split the world into data, seq and model groups, rank = (data_idx *
    S + seq_idx) * M + model_idx (the JAX mesh's axis order), and the replica
    (data x seq) groups, and make it this process's grid. The same grid
    again is returned as it is; another raises. A world M * S does not
    divide is refused (``check_model_parallel``). A group that spans the
    whole world is None (the default group)."""
    global _GRID
    m_size, s_size, world = int(model_parallel), int(seq_parallel), world_size()
    check_model_parallel(world, m_size, s_size)
    if _GRID is not None:
        if (_GRID.model_size, _GRID.seq_size) != (m_size, s_size):
            raise ValueError(f"a grid of model size {_GRID.model_size} and seq size "
                             f"{_GRID.seq_size} is already set up; model_parallel={m_size}, "
                             f"seq_parallel={s_size} asks for another")
        return _GRID
    r, d_size = rank(), world // (m_size * s_size)
    dims = range(d_size), range(s_size), range(m_size)

    def at(d, s, m):
        return (d * s_size + s) * m_size + m

    model_group = _groups([[at(d, s, m) for m in dims[2]] for d in dims[0] for s in dims[1]],
                          r) if m_size > 1 else None
    seq_group = _groups([[at(d, s, m) for s in dims[1]] for d in dims[0] for m in dims[2]],
                        r) if s_size > 1 else None
    data_group = _groups([[at(d, s, m) for d in dims[0]] for s in dims[1] for m in dims[2]],
                         r) if m_size * s_size > 1 else None
    # the replica (data x seq) group: the data group without a seq axis, the
    # world without a model axis
    replica_group = None
    if m_size > 1:
        replica_group = data_group if s_size == 1 else _groups(
            [[at(d, s, m) for d in dims[0] for s in dims[1]] for m in dims[2]], r)
    d_idx, rest = divmod(r, s_size * m_size)
    _GRID = Grid(d_idx, d_size, rest % m_size, m_size, data_group, model_group,
                 rest // m_size, s_size, seq_group, replica_group)
    return _GRID


def grid() -> Grid:
    """This process's grid: the one ``make_grid`` set up, else the whole
    world on the data axis and one rank on the seq and model axes."""
    if _GRID is not None and dist.is_initialized():
        return _GRID
    return Grid(rank(), world_size(), 0, 1, None, None)


def data_rank() -> int:
    return grid().data_rank


def data_size() -> int:
    return grid().data_size


def data_group():
    """The data axis's process group (None: the whole world)."""
    return grid().data_group


def seq_rank() -> int:
    return grid().seq_rank


def seq_size() -> int:
    return grid().seq_size


def seq_group():
    """The seq axis's process group (None: one rank, no collective)."""
    return grid().seq_group


def replica_group():
    """The data x seq group of this rank's model index (None: the whole
    world)."""
    return grid().replica_group


def model_rank() -> int:
    return grid().model_rank


def model_size() -> int:
    return grid().model_size


def model_group():
    """The model axis's process group (None: one rank, no collective)."""
    return grid().model_group


def barrier() -> None:
    if world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def _rank_main(fn, args, rank_, world, device_type, backend, init_method, threads, results):
    if threads:
        torch.set_num_threads(threads)
    try:
        with process_group(rank_, world, device_type, backend, init_method):
            out = fn(*args)
        # pickled here, by value: torch's multiprocessing pickler would pass
        # tensors as handles to this process's memory, which ends next
        results.put((rank_, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank_, False, traceback.format_exc()))


def launch(fn: Callable, world: int, args: Sequence = (), *, device_type: str = "cuda",
           backend: Optional[str] = None, threads: Optional[int] = None,
           timeout: Optional[float] = None) -> list:
    """Run ``fn(*args)`` in ``world`` spawned ranks, each inside
    ``process_group``; what each returned, in rank order (a picklable
    value: tensors on the CPU). ``fn`` must be importable (a module-level
    function). On the CPU each rank takes ``threads`` intra-op threads
    (by default this process's share: its count over ``world``). A rank
    that raises, or dies, or a run past ``timeout`` seconds, stops every
    rank and raises here with the rank's traceback."""
    check_world_size(world, device_type, backend)
    if threads is None and device_type != "cuda":
        threads = max(1, torch.get_num_threads() // world)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    addr = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, tuple(args), r, world, device_type, backend, addr, threads,
                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    out: dict = {}
    try:
        while len(out) < world:
            try:
                r, ok, value = results.get(timeout=0.5)
            except queue.Empty:
                # a rank that returned or raised has put its result first
                dead = [i for i, p in enumerate(procs)
                        if i not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died (exit code "
                                       f"{procs[dead[0]].exitcode}) without a result")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks of {fn.__name__} ran past {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {r} of {world} failed:\n{value}")
            out[r] = pickle.loads(value)
        for p in procs:
            p.join()
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
        results.close()
    return [out[r] for r in range(world)]


def shard_batch(batch: dict, rank_: Optional[int] = None, world: Optional[int] = None,
                batch_axis: int = 1) -> dict:
    """This rank's slice of every microbatch of a global batch stacked (A,
    B, ...): rows rank * B/W .. (rank + 1) * B/W along ``batch_axis``, the
    data axis the JAX package shards (mesh.py:shard_batch), rank and W by
    default this process's data index and the data size, so that the ranks
    of one model group take the same rows. Arrays without that axis pass
    whole."""
    rank_ = data_rank() if rank_ is None else rank_
    world = data_size() if world is None else world
    if world == 1:
        return batch

    def part(x):
        if x.ndim <= batch_axis:
            return x
        b = x.shape[batch_axis]
        if b % world:
            raise ValueError(f"a batch of {b} does not split over {world} ranks")
        n = b // world
        return x[(slice(None),) * batch_axis + (slice(rank_ * n, (rank_ + 1) * n),)]

    return {k: part(v) for k, v in batch.items()}


def gather_strings(strings: Sequence[str]) -> list:
    """Every data rank's strings, data rank 0's first, on every rank (the
    corpus WER over a sharded evaluation; runtime.py:318-339)."""
    if data_size() == 1:
        return list(strings)
    parts: list = [None] * data_size()
    dist.all_gather_object(parts, list(strings), group=data_group())
    return [s for part in parts for s in part]


def check_same_parameters(module: torch.nn.Module) -> None:
    """Raise unless every rank of this rank's replica (data x seq) group
    holds the same parameters and buffers (each tensor's float64 sum and sum
    of squares compared, a gather of two numbers a tensor): the ranks draw
    their weights from one seed."""
    g = grid()
    if g.replica_size == 1:
        return
    with torch.no_grad():
        tensors = list(module.parameters()) + list(module.buffers())
        mine = torch.stack([torch.stack([t.double().sum(), t.double().square().sum()])
                            for t in tensors]).cpu().tolist() if tensors else []
    parts: list = [None] * g.replica_size
    dist.all_gather_object(parts, mine, group=g.replica_group)
    for r, theirs in enumerate(parts):
        if theirs != parts[0]:
            raise RuntimeError(f"replica rank {r} holds other weights than replica rank 0: "
                               "the ranks must build the model from the same seed")


def sum_over_ranks(values: Sequence[float]) -> list:
    """Each of a few host numbers summed over the data ranks, in rank order,
    so every rank gets the same sums (an evaluation's losses and counts)."""
    if data_size() == 1:
        return [float(v) for v in values]
    parts: list = [None] * data_size()
    dist.all_gather_object(parts, [float(v) for v in values], group=data_group())
    return [sum(part[i] for part in parts) for i in range(len(values))]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        all_reduce_sum.calls += 1
        return x

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (None: the world), on
    every one of them; autograd's backward sums the gradients over them as
    well. Each all-reduce, forward or backward, adds one to
    ``all_reduce_sum.calls``."""
    return _AllReduceSum.apply(x, group)


all_reduce_sum.calls = 0


# ---------------------------------------------------------------- sequence-parallel planners


def seq_frame_schedule(encoder_params: dict, t_audio: int) -> list:
    """The frame count at each point where the encoder may shard time, for
    raw audio length ``t_audio``: [after the frontend, after subsampling,
    after each block] (the JAX package's mesh.py:124-144): frames T//hop + 1,
    (l-1)//2 + 1 a subsampling layer (l//2 for VGG), (l-1)//s + 1 after a
    block of stride s."""
    from efficientconformer_torch.config import resolve_block_configs

    p = encoder_params
    hop = p["sample_rate"] * p["hop_length_ms"] // 1000
    f = t_audio // hop + 1
    schedule = [f]
    vgg = p["subsampling_module"] == "VGG"
    for _ in range(p["subsampling_layers"]):
        f = f // 2 if vgg else (f - 1) // 2 + 1
    schedule.append(f)
    for cfg in resolve_block_configs(p):
        if cfg.stride > 1:
            f = (f - 1) // cfg.stride + 1
        schedule.append(f)
    return schedule


def sp_audio_lengths(encoder_params: dict, seq_parallel: int, t_min: int, t_max: int,
                     include_frontend: bool = False) -> list:
    """Audio lengths in [t_min, t_max], on the hop grid, whose whole frame
    schedule (the frontend's point only with ``include_frontend``) divides
    by ``seq_parallel`` (mesh.py:147-169)."""
    p = encoder_params
    hop = p["sample_rate"] * p["hop_length_ms"] // 1000
    out = []
    for t in range(max(t_min - t_min % hop, hop), t_max + 1, hop):
        sched = seq_frame_schedule(p, t)
        pts = sched if include_frontend else sched[1:]
        if all(f % seq_parallel == 0 for f in pts):
            out.append(t)
    return out


def sp_coverage(encoder_params: dict, seq_parallel: int, t_audio: int,
                include_frontend: bool = False) -> tuple:
    """(points that divide by ``seq_parallel``, points) over the encoder's
    points for raw length ``t_audio`` (mesh.py:172-180): 0 divisible points
    means sequence parallelism shards nothing for this batch length."""
    sched = seq_frame_schedule(encoder_params, t_audio)
    pts = sched if include_frontend else sched[1:]
    return sum(1 for f in pts if f % seq_parallel == 0), len(pts)


def sp_pad_align(encoder_params: dict, seq_parallel: int, max_extra_frac: float = 0.3):
    """The loaders' pad aligner under sequence parallelism (mesh.py
    :183-212): a bucket's pad length to the smallest length at or above it,
    on the hop grid, whose whole post-frontend schedule divides by
    ``seq_parallel``. The padding is the host's, so the batch is the same
    with and without sequence parallelism. Raises when no such length lies
    within ``max_extra_frac`` above the target."""
    p = encoder_params
    hop = p["sample_rate"] * p["hop_length_ms"] // 1000

    def align(t_pad: int) -> int:
        t = t_pad + (-t_pad) % hop
        limit = int(t_pad * (1 + max_extra_frac)) + 64 * hop
        while t <= limit:
            n_div, n_tot = sp_coverage(p, seq_parallel, t)
            if n_div == n_tot:
                return t
            t += hop
        raise ValueError(f"no seq_parallel={seq_parallel}-aligned audio length within "
                         f"{max_extra_frac:.0%} above {t_pad}")

    return align


def sp_coverage_warn(encoder_params: dict, seq_parallel: int, t_audio: int) -> None:
    """Warn when a training batch of raw length ``t_audio`` leaves every
    point replicated at seq size ``seq_parallel`` (mesh.py:215-236): the
    seq ranks then compute the same whole activations. Called by the
    trainer once for each distinct length."""
    if seq_parallel <= 1:
        return
    n_div, n_tot = sp_coverage(encoder_params, seq_parallel, t_audio)
    if n_div == 0:
        import warnings

        warnings.warn(
            f"sequence parallelism is INACTIVE for audio length {t_audio}: none of the "
            f"{n_tot} encoder constraint points divide the seq axis ({seq_parallel}); "
            "activations stay time-replicated and the run degrades to data parallelism "
            "over fewer samples. Align loader pad lengths with parallel.mesh.sp_pad_align "
            "(AsrBatchLoader audio_pad_align=...) or pick train_audio_max_length from "
            "parallel.mesh.sp_audio_lengths.", RuntimeWarning, stacklevel=2)
