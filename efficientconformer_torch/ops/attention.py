"""Head and group layouts for attention, and the rel-pos skewing.

Counterpart of the layout helpers, ``rel_to_abs_causal`` and
``rel_to_abs_full`` of efficientconformer_tpu/ops/attention.py. The layout
functions return views where the layout allows it; the attention kernels
take strided (B, H, N, dh) inputs, so no copy is made on the way in.
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
