"""Head and group layouts for attention, the rel-pos skewing, and the
plain softmax attention of the local variants.

Counterpart of efficientconformer_tpu/ops/attention.py: the layout helpers,
every ``rel_to_abs_*`` (plain, strided, local and strided local, causal and
full; ``rel_to_abs_rows``, some rows of the plain and strided ones, for
sequence parallelism) and ``softmax_attention``. The layout functions return views where
the layout allows it; the attention kernels take strided (B, H, N, dh)
inputs, so no copy is made on the way in. The local variants follow the JAX
package's intended transpose of the block axis, not the original PyTorch
repo's reshape, which mixes heads and blocks for H > 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e9


def rel_to_abs_causal(scores: torch.Tensor) -> torch.Tensor:
    """(..., T, Th + T) scores indexed by relative position (column l is
    offset Th + T - 1 - l, most distant past first) -> (..., T, Th + T)
    indexed by absolute key position: pad, flatten, pad, reshape, slice (the
    Music Transformer skewing). Plain tensor ops, so autograd differentiates
    it."""
    *lead, t, l = scores.shape
    s = F.pad(scores, (1, 0))
    s = s.reshape(*lead, t * (l + 1))
    s = F.pad(s, (l - t, 0))
    s = s.reshape(*lead, t + 1, l)
    return s[..., 1:, :]


def rel_to_abs_full(scores: torch.Tensor) -> torch.Tensor:
    """(..., T, Th + 2T - 1) scores indexed by relative position (column l
    is offset T - 1 + Th - l, most distant past first) -> (..., T, Th + T)
    indexed by absolute key position: pad, flatten, pad, reshape, slice."""
    *lead, t, l = scores.shape
    s = F.pad(scores, (0, 1))
    s = s.reshape(*lead, t * (l + 1))
    s = F.pad(s, (0, l - t))
    s = s.reshape(*lead, t + 1, l)
    return s[..., :t, t - 1:]


def rel_to_abs_strided_full(scores: torch.Tensor, stride: int) -> torch.Tensor:
    """(..., T/S, Th + 2T - 1) -> (..., T/S, Th + T) for queries at every
    S-th position: the skew advances S columns a row."""
    *lead, tq, l = scores.shape
    s = F.pad(scores, (0, stride))
    s = s.reshape(*lead, tq * (l + stride))
    s = F.pad(s, (0, l - tq * stride))
    s = s.reshape(*lead, tq + 1, l)
    return s[..., :tq, tq * stride - 1:]


def rel_to_abs_strided_causal(scores: torch.Tensor, stride: int) -> torch.Tensor:
    """(..., T/S, Th + T) -> (..., T/S, Th + T), causal strided queries."""
    *lead, tq, l = scores.shape
    s = F.pad(scores, (1, stride - 1))
    s = s.reshape(*lead, tq * (l + stride))
    s = F.pad(s, (l - stride * tq, 0))
    s = s.reshape(*lead, tq + 1, l)
    return s[..., 1:, :]


def rel_to_abs_rows(scores: torch.Tensor, first: int, keys: int, stride: int = 1,
                    causal: bool = False, rows: int = None) -> torch.Tensor:
    """Rows ``first`` .. ``first`` + n - 1 of ``rel_to_abs_full`` /
    ``rel_to_abs_causal`` (``stride`` 1) or of their strided forms, without
    the other rows, entry for entry: (..., n, L) scores of the queries at
    frames (first + i) * stride, indexed by relative position over a window
    of ``keys`` keys (most distant past first) -> (..., n, keys) indexed by
    absolute key position, entry (i, j) the score at column keys - 1 -
    (first + i) * stride + j. Past a causal row's window (a future key,
    which the causal mask hides, but whose gradient a row with every key
    masked still carries) the whole skew reads zeros and then the next
    row's scores: a causal call passes ``rows`` = n and the scores of the
    row after them too, where one follows. A gather, so autograd
    differentiates it. Sequence parallelism's rows of a rank."""
    n = scores.shape[-2] if rows is None else rows
    l = scores.shape[-1]
    # a zero column after every row, and a zero row where none follows
    ext = F.pad(scores, (0, 1, 0, n + 1 - scores.shape[-2]))
    i = torch.arange(n, device=scores.device)[:, None]
    j = torch.arange(keys, device=scores.device)[None, :]
    at = (first + i) * stride
    row, col = i.expand(n, keys), keys - 1 - at + j
    if causal:
        later = j > at + stride
        row = torch.where(later, i + 1, row)
        col = torch.where(later, j - at - stride - 1, torch.where(j > at, l, col))
    lead = scores.shape[:-2]
    idx = (row * (l + 1) + col).reshape(-1).expand(*lead, n * keys)
    return ext.flatten(-2).gather(-1, idx).view(*lead, n, keys)


def _blocks(scores: torch.Tensor, rows: int) -> torch.Tensor:
    """(B, H, N*rows, L) -> (B, N, H, rows, L)."""
    b, h, t, l = scores.shape
    return scores.reshape(b, h, t // rows, rows, l).transpose(1, 2)


def rel_to_abs_local_full(scores: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """(B, H, T, 2K - 1) -> (B, T/K, H, K, K): each query attends the K keys
    of its own block, at offsets K-1 ... -(K-1)."""
    k = kernel_size
    s = F.pad(_blocks(scores, k), (0, 1))
    b, n, h = s.shape[:3]
    s = F.pad(s.reshape(b, n, h, k * 2 * k), (0, k - 1))
    return s.reshape(b, n, h, k + 1, 2 * k - 1)[:, :, :, :k, k - 1:]


def rel_to_abs_local_causal(scores: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """(B, H, T, K) -> (B, T/K, H, K, K), causal block-local."""
    k = kernel_size
    s = F.pad(_blocks(scores, k), (1, 0))
    b, n, h = s.shape[:3]
    return s.reshape(b, n, h, k + 1, k)[:, :, :, 1:]


def rel_to_abs_strided_local_full(scores: torch.Tensor, kernel_size: int,
                                  stride: int) -> torch.Tensor:
    """(B, H, T/S, 2K - 1) -> (B, T/K, H, K/S, K), strided block-local."""
    k, kq, l = kernel_size, kernel_size // stride, scores.shape[-1]
    s = F.pad(_blocks(scores, kq), (0, stride))
    b, n, h = s.shape[:3]
    s = F.pad(s.reshape(b, n, h, kq * (l + stride)), (0, k - 1))
    return s.reshape(b, n, h, kq + 1, l)[:, :, :, :kq, k - 1:]


def rel_to_abs_strided_local_causal(scores: torch.Tensor, kernel_size: int,
                                    stride: int) -> torch.Tensor:
    """(B, H, T/S, K) -> (B, T/K, H, K/S, K), causal strided block-local."""
    k, kq = kernel_size, kernel_size // stride
    s = F.pad(_blocks(scores, kq), (1, stride - 1))
    b, n, h = s.shape[:3]
    return s.reshape(b, n, h, kq + 1, k)[:, :, :, 1:]


def softmax_attention(scores: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """softmax(scores) v with the softmax in fp32 and the weights cast back
    to the scores' dtype: scores (..., Tq, Tk), v (..., Tk, d). Returns
    (output (..., Tq, d), weights). Plain PyTorch, as the JAX package
    computes the local variants outside any kernel."""
    w = torch.softmax(scores.to(torch.float32), dim=-1).to(scores.dtype)
    return w @ v, w


def split_blocks(x: torch.Tensor, block: int, num_heads: int) -> torch.Tensor:
    """(B, T, D) -> (B, T/block, H, block, D/H)."""
    b, t, d = x.shape
    return x.reshape(b, t // block, block, num_heads, d // num_heads).transpose(2, 3)


def merge_blocks(x: torch.Tensor, dim_model: int) -> torch.Tensor:
    """(B, N, H, K, dh) -> (B, N*K, D)."""
    b, n, h, k, dh = x.shape
    return x.transpose(2, 3).reshape(b, n * k, dim_model)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, T, D) -> (B, H, T, D/H)."""
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, d) -> (B, T, H*d)."""
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def group_time(x: torch.Tensor, num_heads: int, group_size: int) -> torch.Tensor:
    """(B, T, D) -> (B, H, T/G, G*D/H): fold G neighbouring frames into the
    head dimension (grouped attention)."""
    b, t, d = x.shape
    dim_head = group_size * d // num_heads
    return x.reshape(b, t * d // (num_heads * dim_head), num_heads, dim_head).transpose(1, 2)


def ungroup_time(x: torch.Tensor, dim_model: int) -> torch.Tensor:
    """(B, H, T/G, G*D/H) -> (B, T, D)."""
    b, h, tg, dg = x.shape
    return x.transpose(1, 2).reshape(b, (tg * h * dg) // dim_model, dim_model)
