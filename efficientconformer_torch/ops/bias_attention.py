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
  v:     (B, H, Nk, dv)           dv may differ from dqk; any widths
  bias:  (B or 1, H or 1, Nq or 1, Nk), fp32 or bf16, or None; a bias with
         one row and one head, (B or 1, 1, 1, Nk), is a key mask

``bias_attention`` is differentiable: forward and backward are one
``torch.autograd.Function``. Each direction runs its plain PyTorch version
for CPU tensors and its CUDA kernel (csrc/bias_attention_fwd.cu,
csrc/bias_attention_bwd.cu) for CUDA tensors; it has no other path. On the
card the inputs' type picks the route inside each kernel file, never a
failure: bf16 runs the tensor-core kernels (mma.sync, bf16 tiles; counted
in ``tc_launches``), fp32 the fp32 FMA kernels, which keep fp32 products.
Past a width of 256 (bf16: padded to 16) each type takes its chunked
kernels: bf16 streams the features in chunks and forms the outputs in column
groups; fp32 forms the scores of each 64 x 64 (query, key) tile pair once
into an fp32 scratch the wrapper allocates (``work_floats`` per batch and
head: E and its row statistics forward, P, dS and dS^T backward), from
which a second kernel forms every 64-column tile of the outputs. ``route``
names the kernels each call runs and ``routes`` counts the calls by route.
The forward returns (O in the dtype of q, LSE (B, H, Nq)) and saves the LSE for
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

import collections
import ctypes
import functools

import torch

from efficientconformer_torch.ops import _kernels

KERNEL = "bias_attention_fwd"
KERNEL_BWD = "bias_attention_bwd"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The kernel files' compile-time constants that size each route
# (csrc/bias_attention_fwd.cu, csrc/bias_attention_bwd.cu; held to them by
# tests/test_torch_port_bias_widths.py).
SMEM_LIMIT = 232448   # bytes of shared memory one block may use on sm_90 (MAX_SMEM)
WHOLE_WIDTH = 256     # widest dqk and dv (bf16: padded to 16) the kernels that hold a row whole take
FMA_BQ = 64           # fp32: query rows (and keys) of a tile (BQ, BK)
FMA_LDQ = 68          # fp32 forward's row strides: q^T, k^T, P^T (LDQ, LDK, LDP)
FMA_LDK = 65
FMA_LDP = 68
FMA_LDV = 68          # fp32 backward's row strides (LDV, LDS)
FMA_LDS = 65
FMA_COLUMNS = ((32, 2), (64, 4), (96, 6), (128, 8), (192, 12), (256, 16))  # forward jmax_for
FMA_BWD_COLUMNS = ((32, 2), (64, 4), (96, 6), (128, 8))   # backward jmax_for
FMA_WIDE_COLUMNS = ((144, 9), (192, 12), (256, 16))        # jw_for, past 128
FMA_WIDE_ROWS = 16    # rows (or keys) of the wide fp32 backward's tiles (WB)
FC_TILE = 64          # fp32 past WHOLE_WIDTH (csrc/bias_fma.cuh): rows, keys, columns of a tile (T)
FC_KC = 32            # ... depth of a ring stage (KC)
FC_STAGES = 3         # ... stages of the ring (STAGES)
FC_LDT = FC_TILE + 8  # ... row strides of a transposed and a row-major chunk (LDT, LDX)
FC_LDX = FC_TILE + 4
TC_DMAX = (64, 128, 144, 256)   # padded widths of the tensor-core kernels
TC_BQ = 64            # forward: query rows a block (TC_BQ)
TC_BK = 32            # forward: keys a tile (TC_BK)
TC_LDB = TC_BK + 8    # forward: bias tile row stride (TC_LDB)
TC_STAGES = 2         # key tiles in the ring (TC_STAGES)
TC_BLOCK = 64         # backward: rows (or keys) a block (TC_BLOCK)
TC_TILE = 32          # backward: keys (or rows) a tile (TC_TILE)
TC_LDQ = TC_TILE + 8  # backward's bias tile strides (TC_LDQ, TC_LDK)
TC_LDK = TC_BLOCK + 4
FU_N = 128            # the one-pass backward: most rows and keys (FU_N), widest head (FU_D)
FU_D = 64
FU_LD = FU_D + 8
FU_LDC = 32 + 8
CK_KC = 64            # bf16 past WHOLE_WIDTH: features a chunk (CK_KC)
CK_LDC = CK_KC + 8
CK_DOUT = 128         # ... output columns a block: a column group (CK_DOUT)
CK_LDG = CK_DOUT + 8
CK_STAGES = 2


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


Route = collections.namedtuple("Route", "name kernels")
Route.__doc__ = """The kernels a call runs: ``name`` ("fma", "fma_wide", "fma_chunked",
"tc", "tc_chunked" or "fused") and ``kernels``, a (kernel, dynamic shared
memory in bytes) pair for each kernel it launches, in order."""
ROUTES_FWD = ("fma", "fma_chunked", "tc", "tc_chunked")   # ecf_bias_attention_fwd_route's codes
ROUTES_BWD = ("fma", "fma_chunked", "tc", "tc_chunked", "fma_wide", "fused")


def _round16(x: int) -> int:
    return (x + 15) & ~15


def _columns(d: int, table) -> int:
    return next((j for w, j in table if d <= w), table[-1][1])


def tc_width(dqk: int, dv: int) -> int:
    """The padded width the tensor-core kernels see: the wider of dqk and
    dv, each rounded up to 16."""
    return max(_round16(dqk), _round16(dv))


def tc_dmax(dqk: int, dv: int) -> int:
    """The padded width of the tensor-core kernels' shared tiles."""
    return next(d for d in TC_DMAX if tc_width(dqk, dv) <= d or d == TC_DMAX[-1])


def _tc_smem(rows: int, tiles: int, dmax: int) -> int:
    return rows * (dmax + 8) * 2 + tiles


def _r4(floats: int) -> int:
    return (floats + 3) // 4 * 4


# bytes of the fp32 chunked kernels' rings (SCORES_RING, PRODUCT_RING)
_FC_SCORES_RING = FC_STAGES * 2 * FC_KC * FC_LDT * 4
_FC_PRODUCT_RING = FC_STAGES * FC_KC * (FC_TILE + FC_LDX) * 4


def _fwd_route(dtype, dqk: int, dv: int) -> Route:
    if dtype == torch.bfloat16 and tc_width(dqk, dv) > WHOLE_WIDTH:
        ring = CK_STAGES * (TC_BQ + TC_BK) * CK_LDC * 2
        return Route("tc_chunked", (("bias_fwd_tc_chunked_kernel",
                                     ring + 2 * (TC_BK * CK_LDG * 2 + TC_BQ * TC_LDB * 4)),))
    if dtype == torch.bfloat16:
        d = tc_dmax(dqk, dv)
        smem = _tc_smem(TC_BQ + 2 * TC_STAGES * TC_BK, TC_STAGES * TC_BQ * TC_LDB * 4, d)
        return Route("tc", ((f"bias_fwd_tc_kernel<{d},{128 if d == 256 else d}>", smem),))
    if max(dqk, dv) > WHOLE_WIDTH:
        return Route("fma_chunked", (("bias_fwd_chunked_scores_kernel", _FC_SCORES_RING),
                                     ("bias_fwd_chunked_out_kernel",
                                      _FC_PRODUCT_RING + 2 * FC_TILE * 4)))
    j = _columns(dv, FMA_COLUMNS)
    floats = dqk * FMA_LDQ + _r4(dqk * FMA_LDK) + FMA_BQ * 16 * j + FMA_BQ * FMA_LDP
    return Route("fma", ((f"bias_fwd_kernel<float,{j}>", 4 * floats),))


def _bwd_route(dtype, nq: int, nk: int, dqk: int, dv: int) -> Route:
    if dtype == torch.bfloat16:
        if nq <= FU_N and nk <= FU_N and dqk <= FU_D and dv <= FU_D:
            smem = 5 * FU_N * FU_LD * 2 + 2 * FU_N * FU_LDC * 2 + FU_N * 12
            return Route("fused", (("bias_bwd_fused_tc_kernel", smem),))
        if tc_width(dqk, dv) > WHOLE_WIDTH:
            ring = CK_STAGES * (TC_BLOCK + TC_TILE) * CK_LDC * 2
            q = ring + 2 * (TC_TILE * CK_LDG * 2 + TC_BLOCK * TC_LDQ * 4)
            k = ring + 2 * (2 * TC_TILE * CK_LDG * 2 + TC_TILE * (TC_LDK * 4 + 12))
            return Route("tc_chunked", (("bias_bwd_q_tc_chunked_kernel", q),
                                        ("bias_bwd_k_tc_chunked_kernel", k)))
        d = tc_dmax(dqk, dv)
        out = 128 if d == 256 else d
        q = _tc_smem((2 + TC_STAGES) * TC_BLOCK, TC_STAGES * TC_BLOCK * TC_LDQ * 4, d)
        k = _tc_smem((2 + TC_STAGES) * TC_BLOCK, TC_STAGES * TC_TILE * (TC_LDK * 4 + 12), d)
        return Route("tc", ((f"bias_bwd_q_tc_kernel<{d},{out}>", q),
                            (f"bias_bwd_k_tc_kernel<{d},{out}>", k)))
    wb = FMA_WIDE_ROWS
    if max(dqk, dv) > WHOLE_WIDTH:
        return Route("fma_chunked", (("bias_bwd_chunked_scores_kernel",
                                      _FC_SCORES_RING + FC_TILE * (8 + 4)),
                                     ("bias_bwd_chunked_grads_kernel", _FC_PRODUCT_RING)))
    if max(dqk, dv) > 128:
        j = _columns(max(dqk, dv), FMA_WIDE_COLUMNS)
        smem = 4 * (3 * wb + 4 * wb * (16 * j + 1) + 2 * wb * (wb + 1))
        return Route("fma_wide", ((f"bias_bwd_q_wide_kernel<float,{j}>", smem),
                                  (f"bias_bwd_k_wide_kernel<float,{j}>", smem)))
    jq, jd = _columns(dqk, FMA_BWD_COLUMNS), _columns(max(dqk, dv), FMA_BWD_COLUMNS)
    q = dqk * FMA_LDV + dv * FMA_LDV + _r4(16 * jq * FMA_LDS) + _r4(dv * FMA_LDS) \
        + FMA_BQ * FMA_LDV + 3 * FMA_BQ
    k = dqk * FMA_LDV + dv * FMA_LDV + 2 * _r4(16 * jd * FMA_LDS) + _r4(FMA_BQ * FMA_LDS) \
        + FMA_BQ * FMA_LDV + 3 * FMA_BQ
    return Route("fma", ((f"bias_bwd_q_kernel<float,{jq}>", 4 * q),
                         (f"bias_bwd_k_kernel<float,{jd}>", 4 * k)))


@functools.lru_cache(maxsize=4096)
def route(dtype, nq: int, nk: int, dqk: int, dv: int, backward: bool = False) -> Route:
    """The kernels a call at these sizes runs in the forward (or the
    backward) for ``dtype``, each with its dynamic shared memory, computed
    from the kernel files' constants as they size them at launch. Every
    width is taken: past WHOLE_WIDTH the chunked kernels. The widths are the
    caller's; the bf16 rows ``_pad8`` pads to a multiple of 8 round up to
    the same tiles."""
    _check(dtype in _DTYPE_CODE, f"unsupported dtype {dtype}")
    _check(min(nq, nk, dqk, dv) > 0, "empty input")
    return _bwd_route(dtype, nq, nk, dqk, dv) if backward else _fwd_route(dtype, dqk, dv)


def work_floats(dtype, nq: int, nk: int, dqk: int, dv: int, backward: bool = False) -> int:
    """fp32 scratch the route at these sizes takes per (batch, head), in
    floats, as the kernel files size it (ecf_bias_attention_{fwd,bwd}_work):
    on the fp32 chunked route a 64 x 64 tile per (query tile, key tile), of
    E and each row's max and sum in the forward, of P, dS and dS^T in the
    backward; none on the others. It does not call ``route``, which counts
    as one call a launch where chip_smoke.py spies on it."""
    if dtype != torch.float32 or max(dqk, dv) <= WHOLE_WIDTH:
        return 0
    pairs = -(-nq // FC_TILE) * -(-nk // FC_TILE)
    return pairs * (3 * FC_TILE * FC_TILE if backward else FC_TILE * FC_TILE + 2 * FC_TILE)


def smem_bytes(dtype, n, dqk, dv):
    """Dynamic shared memory a block of each kernel takes on the route for
    ``dtype`` at Nq = Nk = n and these widths, in bytes: (forward, backward),
    the backward a tuple of one entry per kernel it launches (the bf16 route
    at N <= 128 and widths <= 64 runs one pass)."""
    return (route(dtype, n, n, dqk, dv).kernels[0][1],
            tuple(b for _, b in route(dtype, n, n, dqk, dv, True).kernels))


def kernel_route(dtype, nq, nk, dqk, dv, backward=False) -> tuple:
    """(route name, shared memory of each kernel) as the compiled kernel
    files choose and size them (ecf_bias_attention_{fwd,bwd}_route and
    _smem); builds the kernels if needed (a CUDA machine). ``route`` is held
    to it on the card."""
    code = _DTYPE_CODE[dtype]
    if not backward:
        lib = _kernels.load(KERNEL)
        fn, smem = lib.ecf_bias_attention_fwd_route, lib.ecf_bias_attention_fwd_smem
        out = lib.ecf_bias_attention_fwd_out_smem
        fn.argtypes = smem.argtypes = out.argtypes = [ctypes.c_int] * 3
        fn.restype, smem.restype, out.restype = ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t
        args = (code, dqk, dv)
        return ROUTES_FWD[fn(*args)], tuple(b for b in (smem(*args), out(*args)) if b)
    lib = _kernels.load(KERNEL_BWD)
    fn = lib.ecf_bias_attention_bwd_route
    q, k = lib.ecf_bias_attention_bwd_q_smem, lib.ecf_bias_attention_bwd_k_smem
    fn.argtypes = q.argtypes = k.argtypes = [ctypes.c_int] * 5
    fn.restype, q.restype, k.restype = ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t
    args = (code, nq, nk, dqk, dv)
    return ROUTES_BWD[fn(*args)], tuple(b for b in (q(*args), k(*args)) if b)


def bias_attention(q, k, v, bias, scale):
    """(o, lse), differentiable in q, k, v and bias: the plain versions for
    CPU tensors, the CUDA kernels for CUDA tensors."""
    tracked = (q, k, v, bias)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tracked):
        return _BiasAttention.apply(q, k, v, bias, scale)
    return bias_attention_fwd(q, k, v, bias, scale)


bias_attention.launches = 0  # forward kernel launches since the caller last reset it
bias_attention.tc_launches = 0  # of those, the bf16 tensor-core route's
bias_attention.routes = collections.Counter()  # of those, by route name (``route``)


def bias_attention_fwd(q, k, v, bias, scale):
    """The forward alone: the plain version for CPU tensors, the kernel for
    CUDA tensors (counted in ``bias_attention.launches``, the bf16
    tensor-core route's also in ``bias_attention.tc_launches``, and each in
    ``bias_attention.routes`` under its route's name)."""
    if q.device.type == "cpu":
        return reference_bias_attention(q, k, v, bias, scale)
    if q.device.type != "cuda":
        raise ValueError(f"bias_attention: no kernel for device {q.device}")
    o, lse = _launch(q, k, v, bias, scale)
    bias_attention.launches += 1
    bias_attention.tc_launches += q.dtype == torch.bfloat16
    bias_attention.routes[route(q.dtype, q.shape[2], k.shape[2], q.shape[3], v.shape[3]).name] += 1
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
    bias_attention_bwd.routes[route(q.dtype, q.shape[2], k.shape[2], q.shape[3], v.shape[3],
                                    True).name] += 1
    return grads


bias_attention_bwd.launches = 0  # backward kernel launches since the caller last reset it
bias_attention_bwd.tc_launches = 0  # of those, the bf16 tensor-core route's
bias_attention_bwd.routes = collections.Counter()  # of those, by route name (``route``)


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


def _work(dtype, b, h, nq, nk, dqk, dv, backward, dev):
    """The route's fp32 scratch for B x H (``work_floats``), or None."""
    n = work_floats(dtype, nq, nk, dqk, dv, backward)
    return torch.empty(b * h * n, dtype=torch.float32, device=dev) if n else None


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
    fn = _bind(lib, "ecf_bias_attention_fwd", 7, 7, 15)
    o = torch.empty((b, nq, h, dv), dtype=q.dtype, device=dev).permute(0, 2, 1, 3)
    lse = torch.empty((b, h, nq), dtype=torch.float64, device=dev)
    work = _work(q.dtype, b, h, nq, nk, dqk, dv, False, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None, o.data_ptr(), lse.data_ptr(),
            work.data_ptr() if work is not None else None,
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
    fn = _bind(lib, "ecf_bias_attention_bwd", 13, 7, 27)
    f32 = torch.float32
    dq = torch.empty((b, nq, h, dqk), dtype=q.dtype, device=dev).permute(0, 2, 1, 3)
    dk = torch.empty((b, nk, h, dqk), dtype=q.dtype, device=dev).permute(0, 2, 1, 3)
    dvo = torch.empty((b, nk, h, dv), dtype=q.dtype, device=dev).permute(0, 2, 1, 3)
    di = torch.empty((b, h, nq), dtype=f32, device=dev)
    ds = torch.empty((b, h, nq, nk), dtype=f32, device=dev) if need_dbias else None
    work = _work(q.dtype, b, h, nq, nk, dqk, dv, True, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None, o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dvo.data_ptr(), di.data_ptr(),
            ds.data_ptr() if ds is not None else None,
            work.data_ptr() if work is not None else None,
            b, h, nq, nk, dqk, dv, int(bias_bf16),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            *do.stride()[:3], *dq.stride()[:3], *dk.stride()[:3], *dvo.stride()[:3],
            *bias_strides, float(scale), stream,
        )
    _raise_on(err, lib, KERNEL_BWD)
    return dq[..., :dqk_out], dk[..., :dqk_out], dvo[..., :dv_out], ds
