"""Sinusoidal relative positional encodings.

Counterpart of efficientconformer_tpu/ops/pos_enc.py (``_sinusoid``,
``relative_encoding``): the encoding is evaluated on the window of relative
positions an attention layer needs, with sin and cos interleaved. The
factorized rel-pos branches fold the same sinusoids into tables
(ops/rel_factorize.py); the skewing branches (the LM-Transformer, causal and
limited-context encoders) run the pos projection over this window, or over
the grouped window (``grouped_relative_encoding``) in a grouped layer.
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


def grouped_relative_encoding(seq_len: int, dim: int, group_size: int, causal: bool = False,
                              device=None) -> torch.Tensor:
    """The relative window of grouped attention over ``seq_len`` frames
    (a multiple of G), most distant past first, as the JAX package's
    ``grouped_relative_encoding`` with no cache history: drawn from the
    table of positions seq_len-1 ... G%2 followed by 0 ... -(seq_len-1) (for
    even G position 0 is in it twice), the causal window its first seq_len
    entries, shape (seq_len, dim); the full window entries G//2 up to
    2 seq_len - G%2 - G//2, shape (2 seq_len - G, dim). Folded G-fold into
    the head dim, it gives 2 seq_len/G - 1 grouped positions."""
    g = group_size
    pos = torch.cat([torch.arange(seq_len - 1, g % 2 - 1, -1, device=device),
                     torch.arange(0, -seq_len, -1, device=device)]).to(torch.float32)
    window = pos[:seq_len] if causal else pos[g // 2:2 * seq_len - g % 2 - g // 2]
    return _sinusoid(window, dim)
