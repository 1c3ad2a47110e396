"""Attention with an additive bias, forward and backward.

Counterpart of efficientconformer_tpu/ops/pallas_attention.py: it computes

    O = softmax(q k^T * scale + bias) v,   LSE = logsumexp(q k^T * scale + bias)

with the softmax in fp32. It serves the attention that cannot be factorized:
the causal Transformer-XL rel-pos attention of the LM-Transformer, whose bias
is the skewed rel-pos scores plus the causal and padding mask, the causal,
limited-context, even-G and strided rel-pos encoder layers, and the absolute
attention (models/attentions.py).

Layout contract:
  q:     (B, H, Nq, dqk)
  k:     (B, H, Nk, dqk)
  v:     (B, H, Nk, dv)           dv may differ from dqk; both at most 256
  bias:  (B or 1, H or 1, Nq or 1, Nk), fp32 or bf16, or None; a bias with
         one row and one head, (B or 1, 1, 1, Nk), is a key mask

``bias_attention`` is differentiable: forward and backward are one
``torch.autograd.Function``. Each direction runs its plain PyTorch version
for CPU tensors and its CUDA kernel (csrc/bias_attention_fwd.cu,
csrc/bias_attention_bwd.cu) for CUDA tensors; it has no other path. On the
card the inputs' type picks the route inside each kernel file, never a
failure: bf16 runs the tensor-core kernels (mma.sync, bf16 tiles; counted
in ``tc_launches``), fp32 the fp32 FMA kernels, which keep fp32 products. The
forward returns (O in the dtype of q, LSE (B, H, Nq)) and saves the LSE for
the backward kernel, which recomputes the probabilities from it; the plain
backward recomputes them with a softmax, as the TPU launcher's _fused_bwd.
The bias gets a gradient only when it requires one: dS summed over the
bias's broadcast axes, as _fused_bwd does.

The LSE is fp64: on a row whose keys all carry the -1e9 mask (it averages V
over the real keys) the row max is about -1e9, where an fp32 step is 64, so
an fp32 LSE would drop the log of the key count and P = exp(S - LSE) would
come out that many times too large. Scores and probabilities stay fp32.
"""

from __future__ import annotations

import ctypes

import torch

from efficientconformer_torch.ops import _kernels

KERNEL = "bias_attention_fwd"
KERNEL_BWD = "bias_attention_bwd"
MAX_WIDTH = 256       # widest dqk and dv the kernels take
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _scores(q, k, bias, scale):
    s = q.to(torch.float32) @ k.to(torch.float32).transpose(-1, -2) * scale
    return s if bias is None else s + bias.to(torch.float32)


def reference_bias_attention(q, k, v, bias, scale):
    """Plain PyTorch version of the forward, computed in fp32: (o, lse),
    the LSE as the row max plus the log of the row sum, in fp64."""
    s = _scores(q, k, bias, scale)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    o = (e / l) @ v.to(torch.float32)
    return o.to(q.dtype), m[..., 0].double() + l[..., 0].double().log()


def reference_bias_attention_bwd(q, k, v, bias, do, scale):
    """Plain PyTorch version of the backward, the arithmetic of the TPU
    launcher's _fused_bwd, in fp32: (dq, dk, dv, ds) with ds (B, H, Nq, Nk)
    the cotangent of the scores, which is the bias's before the fold over
    its broadcast axes."""
    f32 = torch.float32
    p = torch.softmax(_scores(q, k, bias, scale), dim=-1)
    do32 = do.to(f32)
    dp = do32 @ v.to(f32).transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dv = p.transpose(-1, -2) @ do32
    dq = scale * ds @ k.to(f32)
    dk = scale * ds.transpose(-1, -2) @ q.to(f32)
    return dq, dk, dv, ds


def fold_bias_grad(ds: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """ds (B, H, Nq, Nk) summed over the axes along which ``bias``
    broadcasts, in the bias's dtype."""
    axes = [i for i in range(4) if bias.shape[i] == 1 and ds.shape[i] != 1]
    return (ds.sum(axes, keepdim=True) if axes else ds).to(bias.dtype)


def bias_attention(q, k, v, bias, scale):
    """(o, lse), differentiable in q, k, v and bias: the plain versions for
    CPU tensors, the CUDA kernels for CUDA tensors."""
    tracked = (q, k, v, bias)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tracked):
        return _BiasAttention.apply(q, k, v, bias, scale)
    return bias_attention_fwd(q, k, v, bias, scale)


bias_attention.launches = 0  # forward kernel launches since the caller last reset it
bias_attention.tc_launches = 0  # of those, the bf16 tensor-core route's


def bias_attention_fwd(q, k, v, bias, scale):
    """The forward alone: the plain version for CPU tensors, the kernel for
    CUDA tensors (counted in ``bias_attention.launches``, and the bf16
    tensor-core route's also in ``bias_attention.tc_launches``)."""
    if q.device.type == "cpu":
        return reference_bias_attention(q, k, v, bias, scale)
    if q.device.type != "cuda":
        raise ValueError(f"bias_attention: no kernel for device {q.device}")
    o, lse = _launch(q, k, v, bias, scale)
    bias_attention.launches += 1
    bias_attention.tc_launches += q.dtype == torch.bfloat16
    return o, lse


def bias_attention_bwd(q, k, v, bias, o, do, lse, scale, need_dbias=True):
    """The backward alone, (dq, dk, dv, ds): the plain version for CPU
    tensors, the kernel for CUDA tensors (counted in
    ``bias_attention_bwd.launches``, the bf16 tensor-core route's also in
    ``bias_attention_bwd.tc_launches``). The kernel writes ds only when
    asked for it, and returns None in its place otherwise."""
    if q.device.type == "cpu":
        return reference_bias_attention_bwd(q, k, v, bias, do, scale)
    if q.device.type != "cuda":
        raise ValueError(f"bias_attention_bwd: no kernel for device {q.device}")
    grads = _launch_bwd(q, k, v, bias, o, do, lse, scale, need_dbias)
    bias_attention_bwd.launches += 1
    bias_attention_bwd.tc_launches += q.dtype == torch.bfloat16
    return grads


bias_attention_bwd.launches = 0  # backward kernel launches since the caller last reset it
bias_attention_bwd.tc_launches = 0  # of those, the bf16 tensor-core route's


class _BiasAttention(torch.autograd.Function):
    """Forward and backward of the attention. The forward saves o and the
    row log-sum-exp; the backward returns gradients in the inputs' dtypes
    and folds the bias cotangent to the bias's shape when the bias asks for
    one."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        o, lse = bias_attention_fwd(q, k, v, bias, scale)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, bias, o, lse = ctx.saved_tensors
        need_dbias = bias is not None and ctx.needs_input_grad[3]
        dq, dk, dv, ds = bias_attention_bwd(q, k, v, bias, o, do, lse, ctx.scale, need_dbias)
        dbias = fold_bias_grad(ds, bias) if need_dbias else None
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias, None


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"bias_attention: {msg}")


def _bind(lib: ctypes.CDLL, name: str, n_ptrs: int, n_ints: int, n_strides: int):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_int64] * n_strides + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.ecf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ecf_cuda_error_string.restype = ctypes.c_char_p
    return fn


def _checked_inputs(q, k, v, bias):
    """Shape, dtype and device checks shared by both kernels; returns the
    bias with a unit key stride and its (batch, head, row) strides, 0 along
    each axis it broadcasts, and whether it is bf16."""
    b, h, nq, dqk = q.shape
    nk, dv = k.shape[2], v.shape[3]
    _check(q.dtype in _DTYPE_CODE, f"unsupported dtype {q.dtype}")
    _check(k.dtype == q.dtype and v.dtype == q.dtype, "q, k and v differ in dtype")
    _check(k.shape == (b, h, nk, dqk) and v.shape == (b, h, nk, dv),
           f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    _check(nq > 0 and nk > 0 and dqk > 0 and dv > 0, "empty input")
    _check(dqk <= MAX_WIDTH and dv <= MAX_WIDTH,
           f"head widths dqk {dqk} / dv {dv}: the kernels take at most {MAX_WIDTH}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t.stride(-1) == 1, f"{name} needs a unit feature stride")
    tensors = [q, k, v] + ([bias] if bias is not None else [])
    _check(all(t.device == q.device for t in tensors), "tensors lie on different devices")
    if bias is None:
        return None, (0, 0, 0), False
    _check(bias.dtype in _DTYPE_CODE, f"unsupported bias dtype {bias.dtype}")
    _check(bias.dim() == 4 and bias.shape[0] in (1, b) and bias.shape[1] in (1, h)
           and bias.shape[2] in (1, nq) and bias.shape[3] == nk,
           f"bias {tuple(bias.shape)} is not (B or 1, H or 1, Nq or 1, Nk)")
    if bias.stride(-1) != 1 and nk > 1:
        bias = bias.contiguous()
    strides = tuple(bias.stride(i) if bias.shape[i] > 1 else 0 for i in range(3))
    return bias, strides, bias.dtype == torch.bfloat16


def smem_bytes(dtype, n, dqk, dv):
    """Dynamic shared memory a block of each kernel takes on the route for
    ``dtype`` at Nq = Nk = n and these widths, in bytes: (forward, backward),
    the backward a tuple of one entry per kernel it launches (the bf16 route
    at N <= 128 and widths <= 64 runs one pass). Builds the kernels if
    needed (a CUDA machine)."""
    fwd_fn = _kernels.load(KERNEL).ecf_bias_attention_fwd_smem
    bwd_fn = _kernels.load(KERNEL_BWD).ecf_bias_attention_bwd_smem
    fwd_fn.argtypes, fwd_fn.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    bwd_fn.argtypes, bwd_fn.restype = [ctypes.c_int] * 5, ctypes.c_longlong
    code = _DTYPE_CODE[dtype]
    bwd = bwd_fn(code, n, n, dqk, dv)
    return fwd_fn(code, dqk, dv), tuple(x for x in (bwd & 0xFFFFFFFF, bwd >> 32) if x)


def _raise_on(err: int, lib, kernel: str):
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: "
                           f"{lib.ecf_cuda_error_string(err).decode()} ({err})")


def _rows16(t) -> bool:
    """Whether every row of t (B, H, N, d) is 16-byte aligned, as the
    tensor-core kernels copy them (csrc/mma_sm90.cuh, tc::vec16)."""
    return (t.data_ptr() % 16 == 0 and t.shape[-1] % 8 == 0
            and all(st % 8 == 0 for st in t.stride()[:3]))


def _pad8(tensors):
    """The bf16 tensors as the tensor-core kernels take them: when a row of
    one is not 16-byte aligned (a width or a stride not a multiple of 8:
    the grouped head width 135 of EfficientConformer Medium/Large), all as
    contiguous copies, their widths zero-padded to a multiple of 8; the
    zero columns change no score and give zero output columns, which the
    caller drops. The kernels' entry points refuse other bf16 rows. fp32
    tensors as they are."""
    if all(t.dtype != torch.bfloat16 or _rows16(t) for t in tensors):
        return tensors
    return [torch.nn.functional.pad(t, (0, -t.shape[-1] % 8)).contiguous() for t in tensors]


def _launch(q, k, v, bias, scale):
    """csrc/bias_attention_fwd.cu. O is written in (B, Nq, H, dv) memory
    order, so merging the heads after the call is a view. bf16 rows not
    16-byte aligned are padded first (``_pad8``)."""
    dv_out = v.shape[3]
    _checked_inputs(q, k, v, bias)
    q, k, v = _pad8([q, k, v])
    b, h, nq, dqk = q.shape
    nk, dv = k.shape[2], v.shape[3]
    dev = q.device
    bias, bias_strides, bias_bf16 = _checked_inputs(q, k, v, bias)
    lib = _kernels.load(KERNEL)
    fn = _bind(lib, "ecf_bias_attention_fwd", 6, 7, 15)
    o = torch.empty((b, nq, h, dv), dtype=q.dtype, device=dev).permute(0, 2, 1, 3)
    lse = torch.empty((b, h, nq), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None, o.data_ptr(), lse.data_ptr(),
            b, h, nq, nk, dqk, dv, int(bias_bf16),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], *bias_strides,
            float(scale), stream,
        )
    _raise_on(err, lib, KERNEL)
    return o[..., :dv_out], lse


def _launch_bwd(q, k, v, bias, o, do, lse, scale, need_dbias):
    """csrc/bias_attention_bwd.cu: one pass (bf16, Nq and Nk <= 128, widths
    <= 64) or two. q, k, v, o and dO are taken with their batch/head/row
    strides (dO as autograd hands it over); a dO without a unit feature
    stride is copied, and bf16 rows not 16-byte aligned are padded to a
    multiple of 8 (``_pad8``). dq, dk and dv are written in (B, N, H, d)
    order, so that merging heads is a view. Scratch: Di (B, H, Nq) fp32, which the
    query-side pass writes for the key-side pass. ds (B, H, Nq, Nk) fp32 is
    written when asked for."""
    b, h, nq, dqk_out = q.shape
    dv_out = v.shape[3]
    _checked_inputs(q, k, v, bias)
    _check(o.shape == (b, h, nq, dv_out) and do.shape == o.shape, "o / dO do not match q and v")
    _check(o.dtype == q.dtype and o.stride(-1) == 1, "o must be the forward's output")
    _check(tuple(lse.shape) == (b, h, nq) and lse.dtype == torch.float64
           and lse.is_contiguous(), "lse must be the forward's (B, H, Nq) fp64 output")
    do = do.to(q.dtype)
    if do.stride(-1) != 1:
        do = do.contiguous()
    q, k, v, o, do = _pad8([q, k, v, o, do])
    nk, dqk, dv = k.shape[2], q.shape[3], v.shape[3]
    dev = q.device
    bias, bias_strides, bias_bf16 = _checked_inputs(q, k, v, bias)
    lib = _kernels.load(KERNEL_BWD)
    fn = _bind(lib, "ecf_bias_attention_bwd", 12, 7, 27)
    f32 = torch.float32
    dq = torch.empty((b, nq, h, dqk), dtype=q.dtype, device=dev).permute(0, 2, 1, 3)
    dk = torch.empty((b, nk, h, dqk), dtype=q.dtype, device=dev).permute(0, 2, 1, 3)
    dvo = torch.empty((b, nk, h, dv), dtype=q.dtype, device=dev).permute(0, 2, 1, 3)
    di = torch.empty((b, h, nq), dtype=f32, device=dev)
    ds = torch.empty((b, h, nq, nk), dtype=f32, device=dev) if need_dbias else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None, o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dvo.data_ptr(), di.data_ptr(),
            ds.data_ptr() if ds is not None else None,
            b, h, nq, nk, dqk, dv, int(bias_bf16),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            *do.stride()[:3], *dq.stride()[:3], *dk.stride()[:3], *dvo.stride()[:3],
            *bias_strides, float(scale), stream,
        )
    _raise_on(err, lib, KERNEL_BWD)
    return dq[..., :dqk_out], dk[..., :dqk_out], dvo[..., :dv_out], ds
