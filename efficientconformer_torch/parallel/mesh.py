"""Data parallelism: one process a GPU in a ``torch.distributed`` process
group, ``DistributedDataParallel`` over the port's models; the grid of data
and model groups that tensor parallelism (parallel/tensor.py) runs on.

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
- ``make_grid(n)`` splits the world into data and model groups, the JAX
  mesh's ("data", "model") axes (mesh.py:23-53): ``model`` is the innermost
  axis, rank = data_idx * n + model_idx, so a model group is n neighbouring
  ranks. ``data_rank``/``data_size``/``data_group`` and
  ``model_rank``/``model_size``/``model_group`` read it; without a grid the
  whole world is the data axis and the model axis has one rank, so data
  parallelism alone reads the same accessors. The data-parallel helpers
  (``shard_batch``, ``gather_strings``, ``sum_over_ranks``,
  ``check_same_parameters``) work over the data axis: the ranks of one model
  group take the same rows.

Sequence parallelism (the JAX mesh's "seq" axis) is not ported: ROADMAP
Queue 1 item 23.
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
    """This rank's place on the (data, model) grid: its index and the size
    of each axis, and the process groups of its axes (None for an axis of
    one rank, whose collectives are the identity; the data group None with
    more than one rank is the whole world)."""

    data_rank: int
    data_size: int
    model_rank: int
    model_size: int
    data_group: Optional[object]
    model_group: Optional[object]


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


def check_model_parallel(world: int, model_parallel: int) -> None:
    """Refuse a model size that does not divide the world, with the JAX
    package's message (``make_mesh``, mesh.py:40-45)."""
    if model_parallel < 1:
        raise ValueError(f"model_parallel={model_parallel}: at least one rank")
    if world % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} x seq_parallel=1 does not divide "
                         f"the {world} visible device(s)")


def make_grid(model_parallel: int) -> Grid:
    """Split the world into ``model_parallel``-rank model groups and
    world/``model_parallel``-rank data groups (every rank creates every
    group, in the same order, as ``dist.new_group`` requires), and make it
    this process's grid. The same grid again is returned as it is; another
    raises. A world the model size does not divide is refused
    (``check_model_parallel``)."""
    global _GRID
    n, world = int(model_parallel), world_size()
    check_model_parallel(world, n)
    if _GRID is not None:
        if _GRID.model_size != n:
            raise ValueError(f"a grid of model size {_GRID.model_size} is already set up; "
                             f"model_parallel={n} asks for another")
        return _GRID
    r, n_data = rank(), world // n
    model_group = data_group = None
    if n > 1:
        for d in range(n_data):
            g = dist.new_group([d * n + m for m in range(n)])
            if d == r // n:
                model_group = g
    if n_data > 1 and n > 1:
        for m in range(n):
            g = dist.new_group([d * n + m for d in range(n_data)])
            if m == r % n:
                data_group = g
    _GRID = Grid(r // n, n_data, r % n, n, data_group, model_group)
    return _GRID


def grid() -> Grid:
    """This process's grid: the one ``make_grid`` set up, else the whole
    world on the data axis and one rank on the model axis."""
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
    """Raise unless every rank of this rank's data group holds the same
    parameters and buffers (each tensor's float64 sum and sum of squares
    compared, a gather of two numbers a tensor): the ranks draw their
    weights from one seed."""
    if data_size() == 1:
        return
    with torch.no_grad():
        tensors = list(module.parameters()) + list(module.buffers())
        mine = torch.stack([torch.stack([t.double().sum(), t.double().square().sum()])
                            for t in tensors]).cpu().tolist() if tensors else []
    parts: list = [None] * data_size()
    dist.all_gather_object(parts, mine, group=data_group())
    for r, theirs in enumerate(parts):
        if theirs != parts[0]:
            raise RuntimeError(f"data rank {r} holds other weights than data rank 0: the "
                               "ranks must build the model from the same seed")


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
