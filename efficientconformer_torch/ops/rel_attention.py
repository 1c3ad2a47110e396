"""Fused factorized relative-position attention forward.

Counterpart of efficientconformer_tpu/ops/pallas_rel_attention.py. The
factorized rel-pos path (ops/rel_factorize.py) turns Transformer-XL and
grouped relative-position scores into plain attention over augmented
features:

    S[i, j] = qu_i . k_j  +  A_i . C_j
    A_i = [ sin_i * P_i + cos_i * Q_i  |  sin_i * Q_i - cos_i * P_i ]
    C_j = [ cos(pos_j w)               |  sin(pos_j w)              ]
    [P | Q]_i = qv_i @ W_h,   qv_i = qu_i + delta_h  (delta = vbias - u)

Layout contract:
  qu:     (B, H, N,  dh)    content query (+u bias), head-split
  k, v:   (B, H, Nk, dh)
  delta:  (H, dh)           qu + delta = qv
  w:      (H, dh, 2*hd)     folded pos-projection weights ([P | Q] halves)
  rowtab: (N,  2*hd)        [sin | cos](pos_q w_k)
  keytab: (Nk, 2*hd)        [cos | sin](pos_k w_k)
  bias:   (B or 1, 1, 1, Nk) additive key mask, or None

``relpos_attention`` runs the plain PyTorch version for CPU tensors and the
CUDA kernel (csrc/rel_attention_fwd.cu) for CUDA tensors; it has no other
path. Both return (o in the dtype of qu, row log-sum-exp (B, H, N) fp32).
"""

from __future__ import annotations

import ctypes

import torch

from efficientconformer_torch.ops import _kernels

KERNEL = "rel_attention_fwd"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90


def reference_relpos_attention(qu, k, v, delta, w, rowtab, keytab, bias, scale):
    """Plain PyTorch version, computed in fp32: (o, lse)."""
    f32 = torch.float32
    qu32 = qu.to(f32)
    qv = qu32 + delta.to(f32)[None, :, None, :]
    pq = torch.einsum("bhnd,hdk->bhnk", qv, w.to(f32))
    hd = pq.shape[-1] // 2
    p_acc, q_acc = pq[..., :hd], pq[..., hd:]
    sin, cos = rowtab[:, :hd].to(f32), rowtab[:, hd:].to(f32)
    a = torch.cat([sin * p_acc + cos * q_acc, sin * q_acc - cos * p_acc], dim=-1)
    s = (qu32 @ k.to(f32).transpose(-1, -2) + a @ keytab.to(f32).T) * scale
    if bias is not None:
        s = s + bias.to(f32)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.exp(s - lse[..., None]) @ v.to(f32)
    return o.to(qu.dtype), lse


def relpos_attention(qu, k, v, delta, w, rowtab, keytab, bias, scale):
    """(o, lse) of the fused rel-pos attention: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    if qu.device.type == "cpu":
        return reference_relpos_attention(qu, k, v, delta, w, rowtab, keytab, bias, scale)
    if qu.device.type != "cuda":
        raise ValueError(f"relpos_attention: no kernel for device {qu.device}")
    o, lse = _launch(qu, k, v, delta, w, rowtab, keytab, bias, scale)
    relpos_attention.launches += 1
    return o, lse


relpos_attention.launches = 0  # kernel launches since the caller last reset it


def _bind(lib: ctypes.CDLL):
    fn = lib.ecf_relpos_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
            + [ctypes.c_int64] * 13 + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.ecf_relpos_attention_fwd_smem.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.ecf_relpos_attention_fwd_smem.restype = ctypes.c_size_t
        lib.ecf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ecf_cuda_error_string.restype = ctypes.c_char_p
    return fn


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"relpos_attention: {msg}")


def _launch(qu, k, v, delta, w, rowtab, keytab, bias, scale):
    b, h, n, dh = qu.shape
    nk, d2 = k.shape[2], w.shape[-1]
    dev = qu.device
    _check(qu.dtype in _DTYPE_CODE, f"unsupported dtype {qu.dtype}")
    _check(k.dtype == qu.dtype and v.dtype == qu.dtype, "qu, k and v differ in dtype")
    _check(k.shape == (b, h, nk, dh) and v.shape == (b, h, nk, dh),
           f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match qu {tuple(qu.shape)}")
    _check(tuple(delta.shape) == (h, dh), f"delta {tuple(delta.shape)} != {(h, dh)}")
    _check(dh <= 128, f"head width {dh} > 128")
    _check(tuple(w.shape) == (h, dh, d2) and d2 % 2 == 0, f"w {tuple(w.shape)}")
    _check(tuple(rowtab.shape) == (n, d2), f"rowtab {tuple(rowtab.shape)} != {(n, d2)}")
    _check(tuple(keytab.shape) == (nk, d2), f"keytab {tuple(keytab.shape)} != {(nk, d2)}")
    for name, t in (("qu", qu), ("k", k), ("v", v)):
        _check(t.stride(-1) == 1, f"{name} needs a unit feature stride")
    tensors = [qu, k, v, delta, w, rowtab, keytab] + ([bias] if bias is not None else [])
    _check(all(t.device == dev for t in tensors), "tensors lie on different devices")
    f32 = torch.float32
    delta, w, rowtab, keytab = (t.to(f32).contiguous() for t in (delta, w, rowtab, keytab))
    bias_sb = 0
    if bias is not None:
        _check(bias.dim() == 4 and bias.shape[1:] == (1, 1, nk) and bias.shape[0] in (1, b),
               f"bias {tuple(bias.shape)} is not (B or 1, 1, 1, Nk)")
        bias = bias.to(f32).reshape(bias.shape[0], nk).contiguous()
        bias_sb = nk if bias.shape[0] > 1 else 0

    lib = _kernels.load(KERNEL)
    fn = _bind(lib)
    smem = lib.ecf_relpos_attention_fwd_smem(dh, d2)
    _check(smem <= _SMEM_LIMIT, f"head width {dh} + rel width {d2} need {smem} B of "
           f"shared memory, more than {_SMEM_LIMIT}")

    # o is written in (B, N, H, dh) memory order, so merging the heads after
    # the call is a view
    o = torch.empty((b, n, h, dh), dtype=qu.dtype, device=dev).permute(0, 2, 1, 3)
    lse = torch.empty((b, h, n), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            _DTYPE_CODE[qu.dtype], qu.data_ptr(), k.data_ptr(), v.data_ptr(),
            delta.data_ptr(), w.data_ptr(), rowtab.data_ptr(), keytab.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            o.data_ptr(), lse.data_ptr(), b, h, n, nk, dh, d2,
            *qu.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            bias_sb, float(scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: "
                           f"{lib.ecf_cuda_error_string(err).decode()} ({err})")
    return o, lse
