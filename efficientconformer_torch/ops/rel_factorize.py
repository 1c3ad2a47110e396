"""Factorized relative-position attention: tables and folded weights.

Counterpart of efficientconformer_tpu/ops/rel_factorize.py. With sinusoidal
encodings the rel-pos score of the skewing path factorizes exactly:

    S2_h[i, j] = A_h[i] . C[j]
    A_h[i] = [alpha s_i + beta c_i | beta s_i - alpha c_i]   (halves)
    C[j]   = [cos(j w_k) | sin(j w_k)]

with gamma_h = qv_h @ W_h^T, alpha = gamma[0::2], beta = gamma[1::2],
s_i, c_i = sin, cos((i + Th) w_k). The pos layer's bias is dropped: it is
constant along each query row and cancels in the softmax.

``hdp`` is the half-width of the [P | Q] and [sin | cos] halves. The port uses
D/2 (no padding); the parameter exists so that tests can match the JAX
package's lane-padded layout.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _freqs(dim: int) -> np.ndarray:
    return 1.0 / 10000.0 ** (2.0 * np.arange(dim // 2) / dim)


def _pad_half(x: np.ndarray, hdp: int) -> np.ndarray:
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, hdp - x.shape[-1])])


def rel_rowtab(n: int, dim: int, hdp: int, hidden_len: int = 0, stride: int = 1,
               device=None) -> torch.Tensor:
    """(N, 2*hdp) fp32 [sin | cos] of the query-row angles pos_i * w_k, with
    pos_i = i*stride + hidden_len (stride=G for grouped attention)."""
    pos = np.arange(n) * stride + hidden_len
    ang = pos[:, None] * _freqs(dim)[None, :]
    tab = np.concatenate([_pad_half(np.sin(ang), hdp), _pad_half(np.cos(ang), hdp)], -1)
    return torch.as_tensor(tab, dtype=torch.float32, device=device)


def rel_keytab_halves(n_keys: int, dim: int, hdp: int, stride: int = 1,
                      device=None) -> torch.Tensor:
    """(Nk, 2*hdp) fp32 [cos | sin] of the key angles (stride=G for grouped)."""
    pos = np.arange(n_keys) * stride
    ang = pos[:, None] * _freqs(dim)[None, :]
    tab = np.concatenate([_pad_half(np.cos(ang), hdp), _pad_half(np.sin(ang), hdp)], -1)
    return torch.as_tensor(tab, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=64)
def rel_tables(n: int, n_keys: int, dim: int, stride: int,
               device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(rowtab, keytab) in fp32 on ``device`` at half-width D/2, without a
    cached history (hidden_len 0), cached: position constants of the shapes.
    Made outside inference mode, so that training can save them for the
    backward even when inference filled the cache."""
    with torch.inference_mode(False):
        return (rel_rowtab(n, dim, dim // 2, stride=stride, device=device),
                rel_keytab_halves(n_keys, dim, dim // 2, stride=stride, device=device))


def rel_w_plain(pos_kernel: torch.Tensor, num_heads: int, hdp: int) -> torch.Tensor:
    """(H, dh, 2*hdp) folded per-head weights of the plain factorization:
    qv[b, h, n] @ w[h] gives the [P | Q] halves. ``pos_kernel`` is the pos
    layer's (D_in, D_out) kernel, i.e. the transpose of its torch weight."""
    d = pos_kernel.shape[0]
    w = pos_kernel.reshape(d, num_heads, d // num_heads)
    pad = (0, 0, 0, 0, 0, hdp - d // 2)
    w_half = torch.cat([F.pad(w[0::2], pad), F.pad(w[1::2], pad)], dim=0)   # (2hdp, H, dh)
    return w_half.permute(1, 2, 0)


def rel_w_grouped(num_heads: int, dim_head_g: int, pos_kernel: torch.Tensor,
                  group_size: int, hdp: int, hidden_len: int = 0) -> torch.Tensor:
    """(H, dhg, 2*hdp) chunk-phase-folded per-head weights of the grouped
    factorization (same contract as rel_w_plain)."""
    w_pq = _grouped_fold_weights(num_heads, dim_head_g, pos_kernel, group_size, hidden_len)
    pad = (0, hdp - w_pq.shape[-1])
    return torch.cat([F.pad(w_pq[:, :, 0], pad), F.pad(w_pq[:, :, 1], pad)], dim=-1)


def _grouped_fold_weights(h: int, dhg: int, pos_kernel: torch.Tensor, g: int,
                          hidden_len: int) -> torch.Tensor:
    """(H, dhg, 2, D/2) weights mapping grouped qv to the P (s=0) and Q (s=1)
    accumulators.

    Grouped-encoding feature f = head*dhg + l lies in chunk r = f // D and
    reads kernel column f % D. Chunk r has the static phase
    c_r = G - 1 - G//2 + hidden_len - r; the angle (G p + c_r) w separates, so
    with X_r = cos(c_r w), Y_r = sin(c_r w) and alpha/beta the even/odd kernel
    rows of the column,
        P = alpha X_r - beta Y_r,   Q = alpha Y_r + beta X_r.
    This is the JAX package's one-hot/coefficient einsum written as a gather.
    """
    d = pos_kernel.shape[0]
    col, x_r, y_r = _fold_tables(h * dhg, d, g, hidden_len, pos_kernel.device)
    cols = pos_kernel[:, col]                                  # (D, H*dhg)
    alpha, beta = cols[0::2].T, cols[1::2].T                   # (H*dhg, D/2)
    x_r, y_r = x_r.to(pos_kernel.dtype), y_r.to(pos_kernel.dtype)
    p = alpha * x_r - beta * y_r
    q = alpha * y_r + beta * x_r
    return torch.stack([p, q], dim=1).reshape(h, dhg, 2, d // 2)


@functools.lru_cache(maxsize=64)
def _fold_tables(features: int, d: int, g: int, hidden_len: int, device: torch.device):
    """(kernel column of each grouped feature, X_r and Y_r per feature
    (features, D/2) in fp32) on ``device``: static, so cached (outside
    inference mode, as rel_tables)."""
    f = np.arange(features)
    c_r = (g - 1 - g // 2 + hidden_len) - np.arange(g)
    ang = (c_r[:, None] * _freqs(d)[None, :])[f // d]
    with torch.inference_mode(False):
        return (torch.as_tensor(f % d, device=device),
                torch.as_tensor(np.cos(ang), dtype=torch.float32, device=device),
                torch.as_tensor(np.sin(ang), dtype=torch.float32, device=device))
