"""Sinusoidal relative positional encodings.

Counterpart of efficientconformer_tpu/ops/pos_enc.py (``_sinusoid``,
``relative_encoding``): the encoding is evaluated on the window of relative
positions an attention layer needs, with sin and cos interleaved. The
factorized rel-pos branches fold the same sinusoids into tables
(ops/rel_factorize.py); the causal skewing branch (the LM-Transformer) runs
the pos projection over this window.
"""

from __future__ import annotations

import torch


def _sinusoid(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """pos (L,) -> (L, dim) fp32: sin at the even features, cos at the odd
    ones, of pos / 10000^(2i/dim)."""
    i = torch.arange(dim // 2, dtype=torch.float32, device=pos.device)
    angles = pos[:, None].to(torch.float32) / (10000.0 ** (2.0 * i[None, :] / dim))
    return torch.stack([torch.sin(angles), torch.cos(angles)], dim=-1).reshape(pos.shape[0], dim)


def relative_encoding(seq_len: int, dim: int, causal: bool = False,
                      device=None) -> torch.Tensor:
    """The relative window, most distant past first: positions seq_len-1
    ... 0 when causal, shape (seq_len, dim); down to -(seq_len-1) otherwise,
    shape (2 seq_len - 1, dim). The JAX function's causal window with a
    cache history, relative_encoding(1, dim, hidden_len=L-1, causal=True),
    is relative_encoding(L, dim, causal=True) here."""
    stop = 0 if causal else -(seq_len - 1)
    pos = torch.arange(seq_len - 1, stop - 1, -1, dtype=torch.float32, device=device)
    return _sinusoid(pos, dim)
