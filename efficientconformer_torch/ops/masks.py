"""Attention masks from sequence lengths.

Counterpart of efficientconformer_tpu/ops/masks.py. Masks are float tensors
where 1.0 marks a masked (disallowed) position and 0.0 an attendable one;
they are applied additively as ``scores + mask * NEG_INF``. The streaming
(windowed) mask is not ported yet: the encoder raises when one is configured.
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
