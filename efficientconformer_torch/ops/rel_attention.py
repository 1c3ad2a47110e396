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
for CPU tensors and its CUDA kernels (csrc/rel_attention_fwd.cu,
csrc/rel_attention_bwd.cu) for CUDA tensors; it has no other path. Every
head width and every even rel width is taken, in both types and both
directions; the type of qu and the widths pick the kernels (``route``,
computed here from the kernel files' constants and size functions,
mirrored below):
  * bf16, the tensor cores (mma.sync on bf16 tiles; counted in
    ``tc_launches``), which take delta, W and the tables in bf16 with the
    head width padded to a multiple of 16 and each half of the rel width to
    a multiple of 8 (``tc_layout``), as the JAX package casts the pos kernel
    and delta to the compute type. Up to a padded head of 144, where the
    block's [qu | A] fits in shared memory (``tc_fits``), kernels that hold
    it whole ("tc"); past either, the wide route ("tc_wide",
    csrc/relpos_tc.cuh): a prep pass writes the A rows, every product
    streams the augmented width in chunks of 64, and the outputs split into
    column groups of at most 128 (``tc_wide_group``);
  * fp32, FMA kernels in fp32 throughout (csrc/relpos_fma.cuh). The
    forward holds the block's [qu | A] in shared memory where it fits
    ("fma_resident", ``fma_resident``) and otherwise streams it after a
    prep pass ("fma_streamed"), as the backward always does ("fma"); past
    a head of 256 the prep pass stages qu in chunks and the forward's
    outputs split into column groups ("fma_wide").
Launches on a wide route ("tc_wide", "fma_wide") are also counted in
``wide_launches``. The forward returns (o in the dtype of qu, row
log-sum-exp (B, H, N) fp32) and saves the log-sum-exp for the backward,
which recomputes the probabilities from it. The tables get no gradient;
the bias gets one only when it requires it. The plain versions compute in
fp32 from the given inputs; the tensor-core kernels, both bf16 routes,
round where the TPU kernel rounds in bf16 (qv, A before A keytab^T, P
before P V and P^T dO, dS, dpq) and are held to the plain versions on the
same bf16 qu, k, v.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from efficientconformer_torch.ops import _kernels

KERNEL = "rel_attention_fwd"
KERNEL_BWD = "rel_attention_bwd"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448   # bytes of shared memory one block may use on sm_90
# The fp32 route's constants, as csrc/relpos_fma.cuh has them
FMA_MAX_DH = 256      # widest head the forward's blocks and the prep's qu tile hold whole
FMA_BQ = 64           # query rows (and keys) of a tile
FMA_DC = 32           # depth of tile_product's streamed chunks
FMA_LDA = 68          # row strides of its two chunks
FMA_LDB = 65
FMA_LDV = 68          # row strides of tiles read four rows / one word at a time
FMA_LDS = 65
FMA_WCHUNK = 32       # rows of W staged at a time by the prep pass
FMA_LDAS = 129        # row stride of the prep pass's A staging tile
FMA_RESIDENT_MAX_DH = 128   # widest head of the forward's resident kernel (rel_attention_fwd.cu)
# (widest head, output columns a thread) of the forward (jmax_for), and
# (widest column group, columns a thread) of the backward's key side (jd_for)
FMA_COLUMNS = ((32, 2), (64, 4), (96, 6), (128, 8), (192, 12), (256, 16))
FMA_KEY_COLUMNS = ((32, 2), (64, 4), (96, 6), (128, 8))
# The bf16 route's, as csrc/relpos_tc.cuh and the two kernel files have them
TC_MAX_DHP = 144      # widest padded head of the kernels that hold [qu | A] whole ("tc")
TC_WIDE_DMAX = 128    # widest column group of the wide route (rtc::WIDE_DMAX)
TC_BQ = 64            # query rows a block (rtc::BQ)
TC_KC = 64            # rel features a streamed chunk (rtc::KC)
TC_LDC = TC_KC + 8    # its row stride (rtc::LDC)
TC_BK = 64            # keys a tile
TC_TQ = 32            # query rows a streamed tile of the backward's key side
_BQ = 64              # query rows per block of the backward's query-side passes


def _round(x: int, m: int) -> int:
    return -(-x // m) * m


def tc_widths(dh: int, d2: int) -> tuple[int, int]:
    """(dhp, hdp) of the bf16 route: the head width rounded up to 16, half
    the rel width rounded up to 8."""
    return _round(dh, 16), _round(d2 // 2, 8)


def tc_layout(delta, w, rowtab, keytab):
    """delta, W and the tables as the bf16 route takes them: bf16,
    contiguous, the head width zero-padded to dhp and each half of the rel
    width to hdp (``tc_widths``). Fed to the plain version with qu, k and v
    zero-padded alike, they give the plain version's result on the
    bf16-rounded values. Two launches a tensor (a zero fill and one cast
    copy), one where nothing is padded."""
    h, dh, d2 = w.shape
    dhp, hdp = tc_widths(dh, d2)
    hd = d2 // 2

    def padded(t, real, shape):
        if real == shape:
            return t.to(torch.bfloat16).contiguous()
        out = torch.zeros(shape, dtype=torch.bfloat16, device=t.device)
        out[tuple(slice(0, r) for r in real)] = t.reshape(real)
        return out

    def halves(t, rows):
        return padded(t, (rows, 2, hd), (rows, 2, hdp)).reshape(rows, 2 * hdp)

    return (padded(delta, (h, dh), (h, dhp)),
            padded(w, (h, dh, 2, hd), (h, dhp, 2, hdp)).reshape(h, dhp, 2 * hdp),
            halves(rowtab, rowtab.shape[0]), halves(keytab, keytab.shape[0]))


def tc_unpad(ddelta, dw, dh: int, d2: int):
    """ddelta (H, dhp) and dW (H, dhp, 2 hdp) of the bf16 route back at
    widths dh and d2: the inverse of tc_layout's padding."""
    hd, hdp = d2 // 2, dw.shape[-1] // 2
    return ddelta[:, :dh], torch.cat([dw[:, :dh, :hd], dw[:, :dh, hdp:hdp + hd]], dim=-1)


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


relpos_attention.launches = 0       # forward kernel launches since the caller last reset it
relpos_attention.tc_launches = 0    # of those, the bf16 tensor-core route's
relpos_attention.wide_launches = 0  # and of those, the wide routes' ("tc_wide", "fma_wide")


def relpos_attention_fwd(qu, k, v, delta, w, rowtab, keytab, bias, scale):
    """The forward alone: the plain version for CPU tensors, the kernel for
    CUDA tensors (counted in ``relpos_attention.launches``, the tensor-core
    route's also in ``relpos_attention.tc_launches``, a wide route's in
    ``relpos_attention.wide_launches``)."""
    if qu.device.type == "cpu":
        return reference_relpos_attention(qu, k, v, delta, w, rowtab, keytab, bias, scale)
    if qu.device.type != "cuda":
        raise ValueError(f"relpos_attention: no kernel for device {qu.device}")
    o, lse = _launch(qu, k, v, delta, w, rowtab, keytab, bias, scale)
    relpos_attention.launches += 1
    relpos_attention.tc_launches += qu.dtype == torch.bfloat16
    relpos_attention.wide_launches += is_wide(qu.dtype, qu.shape[-1], w.shape[-1])
    return o, lse


def relpos_attention_bwd(qu, k, v, delta, w, rowtab, keytab, bias, o, do, lse, scale,
                         need_dbias=True):
    """The backward alone, (dqu, dk, dv, ddelta, dw, dbias_hb): the plain
    version for CPU tensors, the kernel for CUDA tensors (counted in
    ``relpos_attention_bwd.launches``, the tensor-core route's also in
    ``relpos_attention_bwd.tc_launches``, a wide route's in
    ``relpos_attention_bwd.wide_launches``). dbias_hb is None when the
    kernel is not asked for it."""
    if qu.device.type == "cpu":
        return reference_relpos_attention_bwd(qu, k, v, delta, w, rowtab, keytab, bias, do,
                                              lse, scale)
    if qu.device.type != "cuda":
        raise ValueError(f"relpos_attention_bwd: no kernel for device {qu.device}")
    grads = _launch_bwd(qu, k, v, delta, w, rowtab, keytab, bias, o, do, lse, scale, need_dbias)
    relpos_attention_bwd.launches += 1
    relpos_attention_bwd.tc_launches += qu.dtype == torch.bfloat16
    relpos_attention_bwd.wide_launches += is_wide(qu.dtype, qu.shape[-1], w.shape[-1], True)
    return grads


relpos_attention_bwd.launches = 0       # backward kernel launches since the caller last reset it
relpos_attention_bwd.tc_launches = 0    # of those, the bf16 tensor-core route's
relpos_attention_bwd.wide_launches = 0  # and of those, the wide routes'


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


def _lib(kernel: str, fn_name: str, n_ptrs: int, n_strides: int) -> tuple:
    lib = _kernels.load(kernel)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6
                       + [ctypes.c_int64] * n_strides + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        smem = getattr(lib, f"{fn_name}_smem")
        smem.argtypes = [ctypes.c_int] * 3
        smem.restype = ctypes.c_size_t
        lib.ecf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ecf_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _bind():
    return _lib(KERNEL, "ecf_relpos_attention_fwd", 11, 13)


def _bind_bwd():
    return _lib(KERNEL_BWD, "ecf_relpos_attention_bwd", 22, 25)


def _columns(width: int, table) -> int:
    return next(j for w, j in table if width <= w)


def fma_key_group(dh: int) -> tuple[int, int]:
    """(group width, columns a thread) of the fp32 backward's key side,
    which splits the head width into groups of at most 128 columns
    (k_group_width, jd_for)."""
    groups = -(-dh // 128)
    gw = _round(-(-dh // groups), 16)
    return gw, _columns(gw, FMA_KEY_COLUMNS)


def fma_group_width(dh: int) -> int:
    """The fp32 streamed forward's column group: the whole head up to
    FMA_MAX_DH, past it the fewest groups of at most FMA_MAX_DH columns, of
    equal width rounded up to 16 (fwd_group_width)."""
    groups = -(-dh // FMA_MAX_DH)
    return _round(-(-dh // groups), 16)


def _fma_prep_floats(dh: int) -> int:
    """The fp32 prep pass's shared memory in floats: its qu tile (FMA_WCHUNK
    features of it past FMA_MAX_DH), a W chunk, the A staging tile
    (prep_smem_floats)."""
    return (dh if dh <= FMA_MAX_DH else FMA_WCHUNK) * FMA_LDV + FMA_WCHUNK * 128 \
        + FMA_BQ * FMA_LDAS


def _fma_resident_floats(dh: int, d2: int) -> int:
    """Shared memory of the fp32 forward's resident kernel in floats:
    [qu | A]^T of 64 rows, the key chunks or the probabilities, the V tile
    (resident_smem_floats)."""
    region = max(FMA_BQ * FMA_LDV, 2 * FMA_DC * FMA_LDS)
    return (dh + d2) * FMA_BQ + region + FMA_BQ * 16 * _columns(dh, FMA_COLUMNS)


def fma_resident(dh: int, d2: int) -> bool:
    """Whether the fp32 forward runs its resident kernel, which holds the
    block's [qu | A] whole in shared memory, at head width dh and rel width
    d2 (resident_fits); else it runs the prep pass and the streamed kernel,
    which needs the A rows' scratch."""
    return dh <= FMA_RESIDENT_MAX_DH and 4 * _fma_resident_floats(dh, d2) <= SMEM_LIMIT


def fma_smem_bytes(dh: int, d2: int) -> tuple[int, int]:
    """Shared memory of the fp32 route's largest pass, (forward, backward),
    in bytes at head width dh and rel width d2. Only the resident forward's
    depends on the rel width; past FMA_MAX_DH none depends on the head."""
    tile = 2 * FMA_DC * (FMA_LDA + FMA_LDB)                  # tile_product's chunks
    prep = _fma_prep_floats(dh)
    key = tile + 2 * 16 * fma_key_group(dh)[1] * FMA_LDS + 3 * FMA_BQ
    bwd = 4 * max(prep, key, tile)
    if fma_resident(dh, d2):
        return 4 * _fma_resident_floats(dh, d2), bwd
    fwd = tile + FMA_BQ * 16 * _columns(fma_group_width(dh), FMA_COLUMNS)  # + V
    return 4 * max(prep, fwd), bwd


def tc_smem_bytes(dh: int, d2: int) -> tuple[int, int]:
    """Shared memory of the largest pass of the bf16 kernels that hold [qu |
    A] whole ("tc"), (forward, backward), in bytes at their padded widths
    (tc_smem_bytes, tc_{prep,k,q}_smem)."""
    dhp, hdp = tc_widths(dh, d2)
    d2p = 2 * hdp
    lda, ldt, ldx = dhp + d2p + 8, dhp + 8, max(dhp, 64) + 8
    fwd = TC_BQ * lda + max(TC_BQ * ldt + dhp * TC_LDC, 2 * 2 * TC_BK * ldt + 2 * TC_BK * TC_LDC)
    prep = TC_BQ * lda + max(TC_BQ * ldt + dhp * TC_LDC, 2 * TC_BQ * ldt)
    key = 2 * (TC_BK * lda + TC_BK * ldt + 2 * 2 * TC_TQ * ldt + 2 * TC_TQ * TC_LDC) \
        + 2 * 2 * TC_TQ * 4
    query = 2 * (TC_BQ * ldt + 2 * TC_BK * (TC_LDC + ldx) + dhp * TC_LDC + TC_BQ * TC_LDC) \
        + d2p * 4
    return 2 * fwd, max(2 * prep, key, query)


def tc_fits(dh: int, d2: int, backward: bool = False) -> bool:
    """Whether the bf16 kernels that hold [qu | A] whole take head width dh
    and rel width d2 in the forward (or the backward): a padded head of at
    most TC_MAX_DHP, and their tiles within SMEM_LIMIT (tc_fits)."""
    return (tc_widths(dh, d2)[0] <= TC_MAX_DHP
            and tc_smem_bytes(dh, d2)[int(backward)] <= SMEM_LIMIT)


def tc_wide_group(dh: int) -> int:
    """The wide route's column group at head width dh: the fewest groups
    of at most TC_WIDE_DMAX padded columns, of equal width rounded up to 16
    (rtc::wide_gw)."""
    dhp = tc_widths(dh, 2)[0]
    groups = -(-dhp // TC_WIDE_DMAX)
    return _round(-(-dhp // groups), 16)


def tc_wide_smem_bytes(dh: int) -> tuple[int, int]:
    """Shared memory of the bf16 wide route's largest pass, (forward,
    backward), in bytes: no tile depends on the rel width, and only the
    registers' group width (64 or TC_WIDE_DMAX) on the head
    (tc_wide_smem_bytes, tc_{k,q}_wide_smem; the prep pass's 18,432 bytes
    are the least)."""
    dmax = 64 if tc_wide_group(dh) <= 64 else TC_WIDE_DMAX
    ldg = dmax + 8
    fwd = 2 * 2 * TC_BQ * TC_LDC + 2 * TC_BK * ldg
    key = (2 * (2 * TC_BK + 2 * TC_TQ) * TC_LDC + 2 * 2 * TC_TQ * ldg) * 2 + 2 * 2 * TC_TQ * 4
    query = (TC_BQ * ldg + 2 * TC_BK * (TC_LDC + ldg) + dmax * TC_LDC + TC_BQ * TC_LDC) * 2 \
        + TC_BQ * 4
    return 2 * fwd, max(key, query)


@functools.lru_cache(maxsize=1024)
def route(dtype, dh: int, d2: int, backward: bool = False) -> str:
    """The kernels that take head width dh and rel width d2 in the forward
    (or the backward) for ``dtype``: bf16 "tc" (they hold [qu | A] whole)
    or "tc_wide"; fp32 forward "fma_resident", "fma_streamed" or "fma_wide",
    fp32 backward "fma" or "fma_wide". Every width is taken."""
    _check(dtype in _DTYPE_CODE, f"unsupported dtype {dtype}")
    if dtype == torch.bfloat16:
        return "tc" if tc_fits(dh, d2, backward) else "tc_wide"
    if dh > FMA_MAX_DH:
        return "fma_wide"
    if backward:
        return "fma"
    return "fma_resident" if fma_resident(dh, d2) else "fma_streamed"


def is_wide(dtype, dh: int, d2: int, backward: bool = False) -> bool:
    """Whether ``route`` is a wide one, "tc_wide" or "fma_wide"."""
    return route(dtype, dh, d2, backward).endswith("_wide")


def smem_bytes(dtype, dh: int, d2: int) -> tuple[int, int]:
    """Shared memory a block of the largest pass of the route for
    ``dtype`` needs at head width dh and rel width d2, (forward, backward),
    in bytes, as the kernel files size it at launch."""
    _check(dtype in _DTYPE_CODE, f"unsupported dtype {dtype}")
    if dtype == torch.float32:
        return fma_smem_bytes(dh, d2)
    fits = tc_smem_bytes(dh, d2)
    wide = tc_wide_smem_bytes(dh)
    return tuple(fits[i] if tc_fits(dh, d2, bool(i)) else wide[i] for i in (0, 1))


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"relpos_attention: {msg}")


def _checked_inputs(qu, k, v, delta, w, rowtab, keytab, bias):
    """Shape, dtype and device checks shared by both kernels; returns delta,
    w, rowtab, keytab as the route takes them (fp32 and contiguous, or the
    bf16 route's padded layout, tc_layout), the bias as (B or 1, Nk) fp32
    and its batch stride (0 when it broadcasts)."""
    b, h, n, dh = qu.shape
    nk, d2 = k.shape[2], w.shape[-1]
    _check(qu.dtype in _DTYPE_CODE, f"unsupported dtype {qu.dtype}")
    _check(k.dtype == qu.dtype and v.dtype == qu.dtype, "qu, k and v differ in dtype")
    _check(k.shape == (b, h, nk, dh) and v.shape == (b, h, nk, dh),
           f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match qu {tuple(qu.shape)}")
    _check(tuple(delta.shape) == (h, dh), f"delta {tuple(delta.shape)} != {(h, dh)}")
    _check(tuple(w.shape) == (h, dh, d2) and d2 % 2 == 0, f"w {tuple(w.shape)}")
    _check(tuple(rowtab.shape) == (n, d2), f"rowtab {tuple(rowtab.shape)} != {(n, d2)}")
    _check(tuple(keytab.shape) == (nk, d2), f"keytab {tuple(keytab.shape)} != {(nk, d2)}")
    for name, t in (("qu", qu), ("k", k), ("v", v)):
        _check(t.stride(-1) == 1, f"{name} needs a unit feature stride")
    tensors = [qu, k, v, delta, w, rowtab, keytab] + ([bias] if bias is not None else [])
    _check(all(t.device == qu.device for t in tensors), "tensors lie on different devices")
    if qu.dtype == torch.bfloat16:
        delta, w, rowtab, keytab = tc_layout(delta, w, rowtab, keytab)
    else:
        delta, w, rowtab, keytab = (t.to(torch.float32).contiguous()
                                    for t in (delta, w, rowtab, keytab))
    bias_sb = 0
    if bias is not None:
        _check(bias.dim() == 4 and bias.shape[1:] == (1, 1, nk) and bias.shape[0] in (1, b),
               f"bias {tuple(bias.shape)} is not (B or 1, 1, 1, Nk)")
        bias = bias.to(torch.float32).reshape(bias.shape[0], nk).contiguous()
        bias_sb = nk if bias.shape[0] > 1 else 0
    return delta, w, rowtab, keytab, bias, bias_sb


def _raise_on(err: int, lib, kernel: str):
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: "
                           f"{lib.ecf_cuda_error_string(err).decode()} ({err})")


def _launch(qu, k, v, delta, w, rowtab, keytab, bias, scale):
    b, h, n, dh = qu.shape
    nk = k.shape[2]
    dev = qu.device
    kind = route(qu.dtype, dh, w.shape[-1])
    delta, w, rowtab, keytab, bias, bias_sb = _checked_inputs(
        qu, k, v, delta, w, rowtab, keytab, bias)
    lib, fn = _bind()
    # o is written in (B, N, H, dh) memory order, so merging the heads after
    # the call is a view
    o = torch.empty((b, n, h, dh), dtype=qu.dtype, device=dev).permute(0, 2, 1, 3)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=dev)
    # the prep pass writes the A rows (B, H, N, 2hd at the route's widths)
    # for the streamed kernels; the others form them in shared memory
    atab = (torch.empty((b, h, n, w.shape[-1]), dtype=qu.dtype, device=dev)
            if kind not in ("tc", "fma_resident") else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            _DTYPE_CODE[qu.dtype], qu.data_ptr(), k.data_ptr(), v.data_ptr(),
            delta.data_ptr(), w.data_ptr(), rowtab.data_ptr(), keytab.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            o.data_ptr(), lse.data_ptr(), atab.data_ptr() if atab is not None else None,
            b, h, n, nk, dh, w.shape[-1],
            *qu.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            bias_sb, float(scale), stream,
        )
    _raise_on(err, lib, KERNEL)
    return o, lse


def _launch_bwd(qu, k, v, delta, w, rowtab, keytab, bias, o, do, lse, scale, need_dbias):
    """The passes of csrc/rel_attention_bwd.cu. qu, k, v, o and dO are taken
    with their batch/head/row strides (dO as autograd hands it over: the
    forward wrote O in (B, N, H, dh) order, so dO usually arrives in that
    order too); a dO without a unit feature stride is copied. dqu, dk and dv
    are written in (B, N, H, dh) order, so that merging heads is a view. The
    kernels write one ddelta partial per (query tile, batch, head) and one dW
    partial per (query tile, batch, head) on the bf16 route, per (batch,
    head) on the fp32 route; they are summed here, in a fixed order, so the
    gradients are the same from run to run. Scratch: Di (B, H, N) fp32, and
    by route: fp32, the A rows, later dpq, (B, H, N, 2hd) and dS^T (B, H, Nk,
    N), fp32; bf16, the [qu | A] rows (B, H, Np, dhp + 2hdp), the padded dO
    rows (B, H, Np, dhp) and dS^T (B, H, Nkp, Np) in bf16, Np and Nkp being N
    and Nk rounded up to 64; on the wide bf16 route the A rows (B, H, N,
    2hdp) in place of the first two."""
    b, h, n, dh = qu.shape
    nk, d2 = k.shape[2], w.shape[-1]
    dev = qu.device
    tc = qu.dtype == torch.bfloat16
    wide = is_wide(qu.dtype, dh, d2, backward=True)
    delta, w, rowtab, keytab, bias, bias_sb = _checked_inputs(
        qu, k, v, delta, w, rowtab, keytab, bias)
    _check(o.shape == qu.shape and do.shape == qu.shape, "o / dO do not match qu")
    _check(o.dtype == qu.dtype and o.stride(-1) == 1, "o must be the forward's output")
    _check(tuple(lse.shape) == (b, h, n) and lse.dtype == torch.float32
           and lse.is_contiguous(), "lse must be the forward's (B, H, N) fp32 output")
    do = do.to(qu.dtype)
    if do.stride(-1) != 1:
        do = do.contiguous()
    lib, fn = _bind_bwd()

    f32, bf = torch.float32, torch.bfloat16
    dhw, d2w = (w.shape[1], w.shape[2])          # the route's (padded) widths
    n_tiles = -(-n // _BQ)
    dqu = torch.empty((b, n, h, dh), dtype=qu.dtype, device=dev).permute(0, 2, 1, 3)
    dk = torch.empty((b, nk, h, dh), dtype=qu.dtype, device=dev).permute(0, 2, 1, 3)
    dv = torch.empty((b, nk, h, dh), dtype=qu.dtype, device=dev).permute(0, 2, 1, 3)
    ddelta_part = torch.empty((b * n_tiles, h, dhw), dtype=f32, device=dev)
    di = torch.empty((b, h, n), dtype=f32, device=dev)
    dbias_hb = torch.empty((b, h, nk), dtype=f32, device=dev) if need_dbias else None
    if tc:
        n_p, nk_p = _round(n, 64), _round(nk, 64)
        wt = None
        dw_part = torch.empty((b * n_tiles, h, dhw, d2w), dtype=f32, device=dev)
        if wide:
            atab, qa_do = torch.empty((b, h, n, d2w), dtype=bf, device=dev), None
        else:
            atab = torch.empty((b, h, n_p, dhw + d2w), dtype=bf, device=dev)
            qa_do = torch.empty((b, h, n_p, dhw), dtype=bf, device=dev)
        ds = torch.empty((b, h, nk_p, n_p), dtype=bf, device=dev)
    else:
        wt = w.transpose(1, 2).contiguous()      # (H, 2hd, dh): W^T per head
        dw_part = torch.empty((b, h, dh, d2), dtype=f32, device=dev)
        atab = torch.empty((b, h, n, d2), dtype=f32, device=dev)
        qa_do = None
        ds = torch.empty((b, h, nk, n), dtype=f32, device=dev)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            _DTYPE_CODE[qu.dtype], qu.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), w.data_ptr(), ptr(wt),
            rowtab.data_ptr(), keytab.data_ptr(), ptr(bias),
            dqu.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw_part.data_ptr(),
            ddelta_part.data_ptr(), di.data_ptr(), atab.data_ptr(), ptr(qa_do), ptr(ds),
            ptr(dbias_hb), b, h, n, nk, dh, d2w,
            *qu.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            *do.stride()[:3], *dqu.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
            bias_sb, float(scale), stream,
        )
    _raise_on(err, lib, KERNEL_BWD)
    ddelta, dw = ddelta_part.sum(0), dw_part.sum(0)
    if tc:
        ddelta, dw = tc_unpad(ddelta, dw, dh, d2)
    return dqu, dk, dv, ddelta, dw, dbias_hb
