"""Head and group layouts for attention.

Counterpart of the layout helpers of efficientconformer_tpu/ops/attention.py.
The functions return views where the layout allows it; the rel-pos kernel
takes strided (B, H, N, dh) inputs, so no copy is made on the way in.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9


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
