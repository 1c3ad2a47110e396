"""Fused factorized relative-position attention, forward and backward.

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

``relpos_attention`` is differentiable: forward and backward are one
``torch.autograd.Function``. Each direction runs its plain PyTorch version
for CPU tensors and its CUDA kernel (csrc/rel_attention_fwd.cu,
csrc/rel_attention_bwd.cu) for CUDA tensors; it has no other path. The
forward returns (o in the dtype of qu, row log-sum-exp (B, H, N) fp32) and
saves the log-sum-exp for the backward, which recomputes the probabilities
from it. The tables get no gradient; the bias gets one only when it
requires it.
"""

from __future__ import annotations

import ctypes

import torch

from efficientconformer_torch.ops import _kernels

KERNEL = "rel_attention_fwd"
KERNEL_BWD = "rel_attention_bwd"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
_BQ = 64              # query rows per block of the backward's query-side pass


def _scores(qu, k, delta, w, rowtab, keytab, bias, scale):
    """fp32 scores S and the working tensors (qv, sin, cos) of both
    directions' plain versions."""
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
    return s, qv, sin, cos


def reference_relpos_attention(qu, k, v, delta, w, rowtab, keytab, bias, scale):
    """Plain PyTorch version of the forward, computed in fp32: (o, lse)."""
    s, _, _, _ = _scores(qu, k, delta, w, rowtab, keytab, bias, scale)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.exp(s - lse[..., None]) @ v.to(torch.float32)
    return o.to(qu.dtype), lse


def reference_relpos_attention_bwd(qu, k, v, delta, w, rowtab, keytab, bias, do, lse, scale):
    """Plain PyTorch version of the backward, the arithmetic of the TPU
    kernel's _bwd_kernel, in fp32: (dqu, dk, dv, ddelta, dw, dbias_hb) with
    dW (H, dh, 2hd) and ddelta (H, dh) summed over the batch and dbias_hb
    (B, H, Nk) the column sums of dS of each (batch, head)."""
    f32 = torch.float32
    s, qv, sin, cos = _scores(qu, k, delta, w, rowtab, keytab, bias, scale)
    p = torch.exp(s - lse[..., None])
    do32 = do.to(f32)
    dp = do32 @ v.to(f32).transpose(-1, -2)
    di = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - di)
    dv = p.transpose(-1, -2) @ do32
    dk = scale * ds.transpose(-1, -2) @ qu.to(f32)
    da = scale * ds @ keytab.to(f32)
    hd = da.shape[-1] // 2
    da_e, da_o = da[..., :hd], da[..., hd:]
    dpq = torch.cat([sin * da_e - cos * da_o, cos * da_e + sin * da_o], dim=-1)
    dqv = torch.einsum("bhnk,hdk->bhnd", dpq, w.to(f32))
    dqu = scale * ds @ k.to(f32) + dqv
    dw = torch.einsum("bhnd,bhnk->hdk", qv, dpq)
    return dqu, dk, dv, dqv.sum((0, 2)), dw, ds.sum(2)


def relpos_attention(qu, k, v, delta, w, rowtab, keytab, bias, scale):
    """(o, lse) of the fused rel-pos attention, differentiable in qu, k, v,
    delta, w and bias: the plain versions for CPU tensors, the CUDA kernels
    for CUDA tensors."""
    tracked = (qu, k, v, delta, w, bias)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tracked):
        return _RelPosAttention.apply(qu, k, v, delta, w, rowtab, keytab, bias, scale)
    return relpos_attention_fwd(qu, k, v, delta, w, rowtab, keytab, bias, scale)


relpos_attention.launches = 0  # forward kernel launches since the caller last reset it


def relpos_attention_fwd(qu, k, v, delta, w, rowtab, keytab, bias, scale):
    """The forward alone: the plain version for CPU tensors, the kernel for
    CUDA tensors (counted in ``relpos_attention.launches``)."""
    if qu.device.type == "cpu":
        return reference_relpos_attention(qu, k, v, delta, w, rowtab, keytab, bias, scale)
    if qu.device.type != "cuda":
        raise ValueError(f"relpos_attention: no kernel for device {qu.device}")
    o, lse = _launch(qu, k, v, delta, w, rowtab, keytab, bias, scale)
    relpos_attention.launches += 1
    return o, lse


def relpos_attention_bwd(qu, k, v, delta, w, rowtab, keytab, bias, o, do, lse, scale,
                         need_dbias=True):
    """The backward alone, (dqu, dk, dv, ddelta, dw, dbias_hb): the plain
    version for CPU tensors, the kernel for CUDA tensors (counted in
    ``relpos_attention_bwd.launches``). dbias_hb is None when the kernel is
    not asked for it."""
    if qu.device.type == "cpu":
        return reference_relpos_attention_bwd(qu, k, v, delta, w, rowtab, keytab, bias, do,
                                              lse, scale)
    if qu.device.type != "cuda":
        raise ValueError(f"relpos_attention_bwd: no kernel for device {qu.device}")
    grads = _launch_bwd(qu, k, v, delta, w, rowtab, keytab, bias, o, do, lse, scale, need_dbias)
    relpos_attention_bwd.launches += 1
    return grads


relpos_attention_bwd.launches = 0  # backward kernel launches since the caller last reset it


class _RelPosAttention(torch.autograd.Function):
    """Forward and backward of the fused attention. The forward saves o and
    the row log-sum-exp; the backward returns gradients in the inputs'
    dtypes, none for the tables (position constants), and folds the bias
    cotangent to the bias's (B or 1, 1, 1, Nk) shape when the bias asks for
    one (the TPU launcher's _bwd_rule does the same fold)."""

    @staticmethod
    def forward(ctx, qu, k, v, delta, w, rowtab, keytab, bias, scale):
        o, lse = relpos_attention_fwd(qu, k, v, delta, w, rowtab, keytab, bias, scale)
        ctx.save_for_backward(qu, k, v, delta, w, rowtab, keytab, bias, o, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        qu, k, v, delta, w, rowtab, keytab, bias, o, lse = ctx.saved_tensors
        need_dbias = bias is not None and ctx.needs_input_grad[7]
        dqu, dk, dv, ddelta, dw, dbias_hb = relpos_attention_bwd(
            qu, k, v, delta, w, rowtab, keytab, bias, o, do, lse, ctx.scale, need_dbias)
        dbias = None
        if need_dbias:
            db = dbias_hb.sum(1)                      # (B, Nk): sum over heads
            if bias.shape[0] == 1:
                db = db.sum(0, keepdim=True)          # a bias broadcast over the batch
            dbias = db[:, None, None, :].to(bias.dtype)
        return (dqu.to(qu.dtype), dk.to(k.dtype), dv.to(v.dtype), ddelta.to(delta.dtype),
                dw.to(w.dtype), None, None, dbias, None)


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


def _bind_bwd(lib: ctypes.CDLL):
    fn = lib.ecf_relpos_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 20 + [ctypes.c_int] * 6
            + [ctypes.c_int64] * 25 + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.ecf_relpos_attention_bwd_smem.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.ecf_relpos_attention_bwd_smem.restype = ctypes.c_size_t
        lib.ecf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ecf_cuda_error_string.restype = ctypes.c_char_p
    return fn


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"relpos_attention: {msg}")


def _checked_inputs(qu, k, v, delta, w, rowtab, keytab, bias):
    """Shape, dtype and device checks shared by both kernels; returns delta,
    w, rowtab, keytab in contiguous fp32, the bias as (B or 1, Nk) fp32 and
    its batch stride (0 when it broadcasts)."""
    b, h, n, dh = qu.shape
    nk, d2 = k.shape[2], w.shape[-1]
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
    _check(all(t.device == qu.device for t in tensors), "tensors lie on different devices")
    f32 = torch.float32
    delta, w, rowtab, keytab = (t.to(f32).contiguous() for t in (delta, w, rowtab, keytab))
    bias_sb = 0
    if bias is not None:
        _check(bias.dim() == 4 and bias.shape[1:] == (1, 1, nk) and bias.shape[0] in (1, b),
               f"bias {tuple(bias.shape)} is not (B or 1, 1, 1, Nk)")
        bias = bias.to(f32).reshape(bias.shape[0], nk).contiguous()
        bias_sb = nk if bias.shape[0] > 1 else 0
    return delta, w, rowtab, keytab, bias, bias_sb


def _raise_on(err: int, lib, kernel: str):
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: "
                           f"{lib.ecf_cuda_error_string(err).decode()} ({err})")


def _launch(qu, k, v, delta, w, rowtab, keytab, bias, scale):
    b, h, n, dh = qu.shape
    nk, d2 = k.shape[2], w.shape[-1]
    dev = qu.device
    delta, w, rowtab, keytab, bias, bias_sb = _checked_inputs(
        qu, k, v, delta, w, rowtab, keytab, bias)

    lib = _kernels.load(KERNEL)
    fn = _bind(lib)
    smem = lib.ecf_relpos_attention_fwd_smem(dh, d2)
    _check(smem <= _SMEM_LIMIT, f"head width {dh} + rel width {d2} need {smem} B of "
           f"shared memory, more than {_SMEM_LIMIT}")

    # o is written in (B, N, H, dh) memory order, so merging the heads after
    # the call is a view
    o = torch.empty((b, n, h, dh), dtype=qu.dtype, device=dev).permute(0, 2, 1, 3)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=dev)
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
    _raise_on(err, lib, KERNEL)
    return o, lse


def _launch_bwd(qu, k, v, delta, w, rowtab, keytab, bias, o, do, lse, scale, need_dbias):
    """Both passes of csrc/rel_attention_bwd.cu. qu, k, v, o and dO are
    taken with their batch/head/row strides (dO as autograd hands it over:
    the forward wrote O in (B, N, H, dh) order, so dO usually arrives in that
    order too); a dO without a unit feature stride is copied. dqu, dk and dv
    are written in (B, N, H, dh) order, so that merging heads is a view. The
    kernel writes one dW and one ddelta partial per (query tile, batch,
    head); they are summed here, in a fixed order, so the gradients are the
    same from run to run. Scratch: Di (B, H, N) and the A rows (B, H, N, 2hd)
    in fp32, which the query-side pass writes for the key-side pass."""
    b, h, n, dh = qu.shape
    nk, d2 = k.shape[2], w.shape[-1]
    dev = qu.device
    delta, w, rowtab, keytab, bias, bias_sb = _checked_inputs(
        qu, k, v, delta, w, rowtab, keytab, bias)
    _check(o.shape == qu.shape and do.shape == qu.shape, "o / dO do not match qu")
    _check(o.dtype == qu.dtype and o.stride(-1) == 1, "o must be the forward's output")
    _check(tuple(lse.shape) == (b, h, n) and lse.dtype == torch.float32
           and lse.is_contiguous(), "lse must be the forward's (B, H, N) fp32 output")
    do = do.to(qu.dtype)
    if do.stride(-1) != 1:
        do = do.contiguous()
    wt = w.transpose(1, 2).contiguous()          # (H, 2hd, dh): W^T per head

    lib = _kernels.load(KERNEL_BWD)
    fn = _bind_bwd(lib)
    smem = lib.ecf_relpos_attention_bwd_smem(dh, d2)
    _check(smem <= _SMEM_LIMIT, f"head width {dh} + rel width {d2} need {smem} B of "
           f"shared memory in the backward, more than {_SMEM_LIMIT}")

    f32 = torch.float32
    n_tiles = -(-n // _BQ)
    dqu = torch.empty((b, n, h, dh), dtype=qu.dtype, device=dev).permute(0, 2, 1, 3)
    dk = torch.empty((b, nk, h, dh), dtype=qu.dtype, device=dev).permute(0, 2, 1, 3)
    dv = torch.empty((b, nk, h, dh), dtype=qu.dtype, device=dev).permute(0, 2, 1, 3)
    dw_part = torch.empty((b * n_tiles, h, dh, d2), dtype=f32, device=dev)
    ddelta_part = torch.empty((b * n_tiles, h, dh), dtype=f32, device=dev)
    di = torch.empty((b, h, n), dtype=f32, device=dev)
    atab = torch.empty((b, h, n, d2), dtype=f32, device=dev)
    dbias_hb = torch.empty((b, h, nk), dtype=f32, device=dev) if need_dbias else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            _DTYPE_CODE[qu.dtype], qu.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), w.data_ptr(), wt.data_ptr(),
            rowtab.data_ptr(), keytab.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            dqu.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw_part.data_ptr(),
            ddelta_part.data_ptr(), di.data_ptr(), atab.data_ptr(),
            dbias_hb.data_ptr() if dbias_hb is not None else None,
            b, h, n, nk, dh, d2,
            *qu.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            *do.stride()[:3], *dqu.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
            bias_sb, float(scale), stream,
        )
    _raise_on(err, lib, KERNEL_BWD)
    return dqu, dk, dv, ddelta_part.sum(0), dw_part.sum(0), dbias_hb
