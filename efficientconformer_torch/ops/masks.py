"""Attention masks from sequence lengths.

Counterpart of efficientconformer_tpu/ops/masks.py (and of
``_ensure_kv_mask`` of its models/attentions.py). Masks are float tensors
where 1.0 marks a masked (disallowed) position and 0.0 an attendable one;
they are applied additively as ``scores + mask * NEG_INF``. The windowed
mask serves the causal LM-Transformer and the causal and limited-context
encoders.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def padding_mask(seq_len: int, x_len: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(B,) lengths -> (B, 1, 1, T) float mask, 1.0 at padded key positions."""
    if x_len is None:
        return None
    idx = torch.arange(seq_len, device=x_len.device)
    mask = (idx[None, :] >= x_len[:, None]).to(torch.float32)
    return mask[:, None, None, :]


def look_ahead_mask(seq_len: int, x_len: Optional[torch.Tensor], device=None) -> torch.Tensor:
    """Causal + padding mask: (B or 1, 1, T, T)."""
    return streaming_mask(seq_len, x_len, seq_len, 0, device)


def streaming_mask(seq_len: int, x_len: Optional[torch.Tensor], left_context: int,
                   right_context: int, device=None) -> torch.Tensor:
    """Window + padding mask (B or 1, 1, T, T): query i may attend keys j
    with i - left_context <= j <= i + right_context and j < x_len. On the
    device of ``x_len``, else on ``device``."""
    device = x_len.device if x_len is not None else device
    i = torch.arange(seq_len, device=device)[:, None]
    j = torch.arange(seq_len, device=device)[None, :]
    window = ((j > i + right_context) | (j < i - left_context)).to(torch.float32)[None, None]
    pad = padding_mask(seq_len, x_len)
    return window if pad is None else torch.maximum(window, pad)


def local_block_diagonal(mask: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """The diagonal K x K blocks of a (B, 1, T, T) mask, (B, T/K, 1, K, K):
    the masks of block-local attention; a key-only (B, 1, 1, T) mask gives
    (B, T/K, 1, 1, K), broadcast over each block's queries."""
    b, h, tq, tk = mask.shape
    n = tk // kernel_size
    if tq == 1:
        return mask.reshape(b, h, 1, n, kernel_size).permute(0, 3, 1, 2, 4)
    blocks = mask.reshape(b, h, n, kernel_size, n, kernel_size)
    # (B, H, K, K, N) -> (B, N, H, K, K)
    return torch.diagonal(blocks, dim1=2, dim2=4).permute(0, 4, 1, 2, 3)


def ensure_kv_mask(mask: Optional[torch.Tensor], t_in: int, chunk: int,
                   device=None) -> Optional[torch.Tensor]:
    """A mask padded (with 1.0) to a multiple of ``chunk``; a key mask of
    the padding alone when none is given but the input needs padding."""
    if mask is None:
        if t_in % chunk == 0:
            return None
        base = torch.zeros((1, 1, 1, t_in), device=device)
        return F.pad(base, (0, (-t_in) % chunk), value=1.0)
    return pad_mask_to_multiple(mask, chunk)


def pad_to_multiple(x: torch.Tensor, chunk: int) -> tuple[torch.Tensor, int]:
    """Zero-pad the time axis of x (B, T, ...) up to the next multiple of
    ``chunk``. Returns (padded, padding_amount)."""
    pad = (-x.shape[1]) % chunk
    if pad == 0:
        return x, 0
    return F.pad(x, [0, 0] * (x.dim() - 2) + [0, pad]), pad


def pad_mask_to_multiple(mask: Optional[torch.Tensor], chunk: int) -> Optional[torch.Tensor]:
    """Pad the last (and, if square, second-to-last) axis of an attention mask
    to a multiple of ``chunk`` with 1.0 (masked)."""
    if mask is None:
        return None
    pad_k = (-mask.shape[-1]) % chunk
    if pad_k == 0:
        return mask
    if mask.shape[-2] == 1:
        return F.pad(mask, (0, pad_k), value=1.0)
    pad_q = (-mask.shape[-2]) % chunk
    return F.pad(mask, (0, pad_k, 0, pad_q), value=1.0)
