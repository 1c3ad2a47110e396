"""Sequence parallelism: the encoder's activations split along time over
the seq groups of parallel/mesh.py's grid.

Counterpart of the JAX package's "seq" mesh axis (parallel/mesh.py:57-80,
``seq_constraint``; models/encoders.py:78,96,155), where GSPMD derives the
halo exchanges and the gathers that a time-sharded activation implies. Here
each is an explicit ``autograd.Function`` over a seq group (a
``tensor.Region``: group, rank, size):

- ``split_time``: a replicated tensor to this rank's frames (an even split);
  its backward all-gathers the gradient and divides it by the seq size;
- ``gather_time``: this rank's frames to the whole (an all-gather); its
  backward sums the gradient over the seq group and keeps the rank's frames
  (an all-reduce, then the slice: a reduce-scatter). It serves the attention's
  keys and values (each rank's queries send gradient to every key), the
  heads' input, the InterCTC taps and a point whose frame count does not
  divide;
- ``halo``: this rank's frames with its neighbours' edge frames on either
  side, zeros past the sequence's ends as the convolution's own padding gives
  (an all-gather of the edge frames; of the whole tensor when a rank holds
  fewer frames than the halo); its backward returns each edge's gradient to
  its owner, which adds it to its own;
- ``all_reduce``: the sum over the seq group of each rank's part of a
  quantity summed over time (linear attention's softmax denominators and
  k^T v); its backward sums the gradient over the group likewise, since each
  rank's part feeds every rank's rows.

The gradients follow one rule: every rank's gradient of a parameter is its
part of a sum over the seq group, so that DDP's average over the data x seq
group (``mesh.replica_group``) is the one-process gradient. A replicated
activation's gradient is then the whole gradient on every rank, and a
time-sharded one's is S times the rank's frames' gradient: ``gather_time``
sums the S equal gradients of the replicated side, ``split_time`` divides the
gathered S-fold gradient by S. The heads, the decoder and the joint, which
every seq rank computes whole from the gathered frames, then count once, as
the encoder's sharded blocks do.

Over gloo (the CPU, or ranks sharing one card) half-precision tensors travel
as fp32, as parallel/tensor.py sends them; the reduce-scatter is an
all-reduce and a slice on every backend, so NCCL and gloo give the same
numbers. Each collective adds one to ``calls["all_gather"]``,
``calls["halo"]``, ``calls["reduce_scatter"]`` or ``calls["all_reduce"]``.

``Span`` is where a rank's frames lie: ``even(total, seq)`` the even split
of a point whose frame count divides; ``strided(span, s)`` the frames a
convolution of stride s leaves the rank (the outputs whose input frame
j * s it holds, so a rank whose offset is odd starts one frame later);
``conv1d_time`` runs a depthwise (any) Conv1d on the rank's frames through a
halo; ``window`` cuts a replicated tensor's frames with the padding past its
ends, where a subsampling computes the rank's frames from the whole input.
``shard_encoder_`` turns sequence parallelism on in an encoder: every layer
the JAX package's seq mesh runs computes on the rank's frames (models/
modules.py, attentions.py, encoders.py say how each exchanges what it needs).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from efficientconformer_torch.parallel import mesh
from efficientconformer_torch.parallel import tensor as tp_ops
from efficientconformer_torch.parallel.tensor import Region

calls = {"all_gather": 0, "halo": 0, "reduce_scatter": 0, "all_reduce": 0}


def reset_calls() -> None:
    for k in calls:
        calls[k] = 0


def region() -> Region:
    """This process's seq group, from parallel/mesh.py's grid."""
    g = mesh.grid()
    return Region(g.seq_group, g.seq_rank, g.seq_size)


class Span(NamedTuple):
    """This rank's frames [start, start + length) of ``total`` along time,
    over the seq group ``seq``."""

    total: int
    start: int
    length: int
    seq: Region


def even(total: int, seq: Region) -> Span:
    """The even split of ``total`` frames (which the seq size divides)."""
    n = total // seq.size
    return Span(total, seq.rank * n, n, seq)


def strided(span: Span, stride: int) -> Span:
    """The output frames of a convolution of ``stride`` that this rank
    computes: those whose input frame j * stride it holds."""
    if stride == 1:
        return span
    first = -(-span.start // stride)
    last = -(-(span.start + span.length) // stride)
    return Span((span.total - 1) // stride + 1, first, last - first, span.seq)


def splits_evenly(total: int, stride: int, size: int) -> bool:
    """Whether a block of ``stride`` keeps the even split: ``total`` and
    its output's frame count divide by ``size`` and every rank's strided
    output frames are the output's even split (the same answer on every
    rank)."""
    out = (total - 1) // stride + 1
    if total % size or out % size:
        return False
    return all(strided(even(total, Region(None, r, size)), stride)[1:3]
               == even(out, Region(None, r, size))[1:3] for r in range(size))


# ---------------------------------------------------------------- collectives


def _gather(x: torch.Tensor, seq: Region, dim: int) -> torch.Tensor:
    calls["all_gather"] += 1
    return torch.cat(tp_ops.gather_parts(x, seq), dim=dim)


def _slice(x: torch.Tensor, seq: Region, dim: int) -> torch.Tensor:
    n = x.shape[dim] // seq.size
    return x.narrow(dim, seq.rank * n, n)


def _reduce_scatter(x: torch.Tensor, seq: Region, dim: int) -> torch.Tensor:
    calls["reduce_scatter"] += 1
    return _slice(tp_ops.reduce_parts(x, seq.group), seq, dim).contiguous()


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq, dim):
        ctx.seq, ctx.dim = seq, dim
        return _slice(x, seq, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.seq, ctx.dim) / ctx.seq.size, None, None


class _GatherTime(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq, dim):
        ctx.seq, ctx.dim = seq, dim
        return _gather(x, seq, dim)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.seq, ctx.dim), None, None


def split_time(x: torch.Tensor, seq: Region, dim: int = 1) -> torch.Tensor:
    """This rank's even share of the replicated ``x`` along ``dim``."""
    if x.shape[dim] % seq.size:
        raise ValueError(f"{x.shape[dim]} frames do not split over {seq.size} ranks")
    return _Split.apply(x, seq, dim % x.dim())


def gather_time(x: torch.Tensor, seq: Region, dim: int = 1) -> torch.Tensor:
    """The seq group's even shares of a tensor concatenated along ``dim``:
    the whole, on every rank; the gradient summed over the group and cut to
    the rank's share."""
    return _GatherTime.apply(x, seq, dim % x.dim())


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq = seq
        calls["all_reduce"] += 1
        return tp_ops.reduce_parts(x, seq.group)

    @staticmethod
    def backward(ctx, grad):
        calls["all_reduce"] += 1
        return tp_ops.reduce_parts(grad.contiguous(), ctx.seq.group), None


def all_reduce(x: torch.Tensor, seq: Region) -> torch.Tensor:
    """The sum over the seq group of each rank's ``x`` (its frames' part of
    a sum over time); the gradient summed over the group likewise."""
    return _AllReduce.apply(x, seq)


def softmax_time_product(k: torch.Tensor, v: torch.Tensor, seq: Region) -> torch.Tensor:
    """softmax over time (dim -2) of ``k`` transposed against ``v``, over
    every rank's frames of the seq group: k (..., T_r, dk), v (..., T_r, dv)
    of this rank's frames -> (..., dk, dv), in v's dtype. The shift is the
    group's maximum (by an uncounted all-reduce, outside autograd: the
    softmax does not depend on it); each rank's sum of exp(k - max) and of
    its products with v travel in one ``all_reduce``, in fp32."""
    k32 = k.float()
    top = k32.detach().amax(dim=-2, keepdim=True)
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=seq.group)
    w = torch.exp(k32 - top)
    part = torch.cat([torch.einsum("...td,...te->...de", w, v.float()),
                      w.sum(dim=-2)[..., None]], dim=-1)
    total = all_reduce(part, seq)
    return (total[..., :-1] / total[..., -1:]).to(v.dtype)


def window(x: torch.Tensor, lo: int, hi: int, dim: int = -1, value: float = 0.0):
    """Frames [lo, hi) along ``dim`` of a tensor every rank holds whole,
    ``value`` past its ends (a convolution's zeros, a max-pool's -inf)."""
    n = x.shape[dim]
    part = x.narrow(dim, max(lo, 0), max(min(hi, n) - max(lo, 0), 0))
    before, after = max(-lo, 0), max(hi - n, 0)
    if before == after == 0:
        return part
    pad = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [before, after]
    return F.pad(part, pad, value=value)


def _zeros_like_along(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[dim] = n
    return x.new_zeros(shape)


def _halo_forward(x, seq, left, right, dim):
    calls["halo"] += 1
    n = x.shape[dim]
    if n < max(left, right):
        # the halo reaches past a neighbour: the whole tensor, zero-padded
        full = torch.cat(tp_ops.gather_parts(x, seq), dim=dim)
        pad = [0, 0] * (x.dim() - 1 - dim) + [left, right]
        return F.pad(full, pad).narrow(dim, seq.rank * n, n + left + right)
    # my first ``right`` frames are the previous rank's right halo, my last
    # ``left`` the next rank's left halo
    edges = torch.cat([x.narrow(dim, 0, right), x.narrow(dim, n - left, left)], dim=dim)
    parts = tp_ops.gather_parts(edges, seq)
    before = (parts[seq.rank - 1].narrow(dim, right, left) if seq.rank > 0
              else _zeros_like_along(x, dim, left))
    after = (parts[seq.rank + 1].narrow(dim, 0, right) if seq.rank + 1 < seq.size
             else _zeros_like_along(x, dim, right))
    return torch.cat([before, x, after], dim=dim)


def _halo_backward(grad, seq, left, right, dim):
    calls["halo"] += 1
    n = grad.shape[dim] - left - right
    if n < max(left, right):
        full = _zeros_like_along(grad, dim, n * seq.size + left + right)
        full.narrow(dim, seq.rank * n, n + left + right).copy_(grad)
        full = full.narrow(dim, left, n * seq.size)
        return _slice(tp_ops.reduce_parts(full, seq.group), seq, dim).contiguous()
    g_before, own, g_after = grad.split([left, n, right], dim=dim)
    parts = tp_ops.gather_parts(torch.cat([g_before, g_after], dim=dim).contiguous(), seq)
    own = own.clone()
    if seq.rank + 1 < seq.size:      # the next rank's left halo is my last frames
        own.narrow(dim, n - left, left).add_(parts[seq.rank + 1].narrow(dim, 0, left))
    if seq.rank > 0:                 # the previous rank's right halo is my first frames
        own.narrow(dim, 0, right).add_(parts[seq.rank - 1].narrow(dim, left, right))
    return own


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq, left, right, dim):
        ctx.args = (seq, left, right, dim)
        return _halo_forward(x.contiguous(), seq, left, right, dim)

    @staticmethod
    def backward(ctx, grad):
        return _halo_backward(grad.contiguous(), *ctx.args), None, None, None, None


def halo(x: torch.Tensor, left: int, right: int, seq: Region, dim: int = 1) -> torch.Tensor:
    """This rank's even share ``x`` with ``left`` frames of the previous
    rank before it and ``right`` of the next after it along ``dim``, zeros
    past the first and last rank."""
    if left == right == 0:
        return x
    return _Halo.apply(x, seq, left, right, dim % x.dim())


def conv1d_time(conv, x: torch.Tensor, span: Span):
    """``conv`` (models/layers.Conv1d: 'same' or causal padding, any stride
    and groups) over the time axis (dim 2) of this rank's frames ``x`` (B,
    C, length): (its output frames, ``strided(span, stride)``), those of the
    whole sequence's convolution."""
    k, s = conv.kernel_size[0], conv.stride[0]
    left = k - 1 if conv.causal else conv.padding[0]
    right = k - 1 - left
    window = halo(x, left, right, span.seq, dim=2)
    out = strided(span, s)
    first = out.start * s - span.start        # the first output's window offset
    w = conv.noisy("weight").to(x.dtype)
    b = conv.bias.to(x.dtype) if conv.bias is not None else None
    y = F.conv1d(window[..., first:], w, b, stride=s, groups=conv.groups)
    return y, out


# ---------------------------------------------------------------- the encoder


def shard_encoder_(encoder, seq: Region) -> None:
    """Turn sequence parallelism over the seq group ``seq`` on in
    ``encoder`` (models/encoders.ConformerEncoder): its subsampling, blocks
    and encodings then compute on the rank's frames. Remat runs under it
    (the recompute repeats the block's collectives)."""
    if seq.size > 1:
        encoder.seq = seq


def covering(span: Span, group: int) -> tuple[int, int]:
    """The groups of ``group`` frames [g0, g1) that cover this rank's frames."""
    return span.start // group, -(-(span.start + span.length) // group)

