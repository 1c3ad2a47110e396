"""Sinusoidal positional encodings: absolute, relative, grouped-relative.

Counterpart of efficientconformer_tpu/ops/pos_enc.py (``_sinusoid``,
``absolute_encoding``, ``relative_encoding``, ``grouped_relative_encoding``):
the encoding is evaluated on the window of relative positions an attention
layer needs, with sin and cos interleaved. The
factorized rel-pos branches fold the same sinusoids into tables
(ops/rel_factorize.py); the skewing branches (the LM-Transformer, causal and
limited-context encoders, even G, strided and local attention) run the pos
projection over this window, or over the grouped window
(``grouped_relative_encoding``) in a grouped layer. The absolute encoding
is added to the input of the layers without rel-pos attention.
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
                      device=None, hidden_len: int = 0) -> torch.Tensor:
    """The relative window of ``seq_len`` queries after ``hidden_len``
    cached keys, most distant past first: positions seq_len-1+hidden_len
    ... 0 when causal, shape (hidden_len + seq_len, dim); down to
    -(seq_len-1) otherwise, shape (hidden_len + 2 seq_len - 1, dim), as the
    JAX function's. The fixed-capacity step's window of L slots is
    relative_encoding(L, dim, causal=True), the growing cache's one token
    after L-1 relative_encoding(1, dim, causal=True, hidden_len=L-1): the
    same positions."""
    stop = 0 if causal else -(seq_len - 1)
    pos = torch.arange(seq_len - 1 + hidden_len, stop - 1, -1, dtype=torch.float32,
                       device=device)
    return _sinusoid(pos, dim)


def absolute_encoding(seq_len: int, dim: int, device=None) -> torch.Tensor:
    """(T, dim) absolute sinusoidal encoding of positions 0 ... T-1, the
    input encoding of the encoders and decoders without rel-pos attention."""
    return _sinusoid(torch.arange(seq_len, dtype=torch.float32, device=device), dim)


def absolute_encoding_at(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """(B, dim) absolute encoding of the positions pos (B,), rows of
    ``absolute_encoding`` taken on the device without reading pos back."""
    return _sinusoid(pos, dim)


def grouped_relative_encoding(seq_len: int, dim: int, group_size: int, causal: bool = False,
                              device=None, hidden_len: int = 0) -> torch.Tensor:
    """The relative window of grouped attention over ``seq_len`` frames
    (a multiple of G) after ``hidden_len`` cached frames, most distant past
    first, as the JAX package's ``grouped_relative_encoding``: drawn from
    the table of positions L-1 ... G%2 followed by 0 ... -(L-1), L = seq_len
    + hidden_len (for even G position 0 is in it twice); the causal window
    its last seq_len + hidden_len entries of the first half, shape
    (hidden_len + seq_len, dim); the full window entries L - seq_len + G//2
    - hidden_len up to L - G%2 + seq_len - G//2, shape (hidden_len +
    2 seq_len - G, dim). Folded G-fold into the head dim, the full window
    gives hidden_len/G + 2 seq_len/G - 1 grouped positions."""
    g = group_size
    lmax = seq_len + hidden_len
    pos = torch.cat([torch.arange(lmax - 1, g % 2 - 1, -1, device=device),
                     torch.arange(0, -lmax, -1, device=device)]).to(torch.float32)
    if causal:
        window = pos[lmax - seq_len - hidden_len:lmax]
    else:
        window = pos[lmax - seq_len + g // 2 - hidden_len:lmax - g % 2 + seq_len - g // 2]
    return _sinusoid(window, dim)
