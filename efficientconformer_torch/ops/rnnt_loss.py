"""RNN-T (transducer) loss: the lattice forward (alphas) and backward.

Counterpart of efficientconformer_tpu/ops/rnnt_loss.py (the ``lax.scan``
specification, ``rnnt_loss_from_gathered``) and ops/pallas_rnnt.py (the
wavefront kernels ``_fwd_kernel`` and ``_bwd_kernel``). Blank id 0, gather
formulation: only the log-normaliser and two gathered rows of the joint
logits enter the recursion,

    blank[t, u] = log P(blank | t, u),   emit[t, u] = log P(y_{u+1} | t, u)
    alpha[0, 0] = 0
    alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
                            alpha[t, u-1] + emit[t, u-1])
    ll          = alpha[f_len-1, y_len] + blank[f_len-1, y_len]

and the loss is -ll per utterance. The backward runs the beta recursion
from the utterance's terminal cell (beta[f_len-1, y_len] = blank there),
over cells t < f_len, u <= y_len (LOG_EPS elsewhere), and gives

    d ll / d blank[t, u] = exp(alpha[t, u] + blank[t, u] + beta[t+1, u] - ll)
    d ll / d emit[t, u]  = exp(alpha[t, u] + emit[t, u] + beta[t, u+1] - ll)

with beta[t+1, u] := 0 at the terminal cell and exact zeros outside the
utterance's lattice (the warp_rnnt formulation, as the TPU kernel).

``rnnt_loss_from_gathered`` is one ``torch.autograd.Function`` over both
directions: for CPU tensors it runs the plain versions
(``reference_rnnt_alphas``, ``reference_rnnt_grads``), for CUDA tensors the
kernels csrc/rnnt_fwd.cu and csrc/rnnt_bwd.cu (the beta recursion, then the
gradients of every cell in a second kernel), and it has no other path.
Both versions run the same arithmetic in the same order: cells are visited
one anti-diagonal d = t + u at a time, and logaddexp(a, b) is
max(a, b) + log1p(exp(-|a - b|)).

Labels inside y_len must lie in [1, V): the JAX loss would read an
out-of-range label as a clipped gather, the port refuses it (on the host
for CPU labels, with a device-side assert for labels on the card).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from efficientconformer_torch.ops import _kernels

LOG_EPS = -1e30
KERNEL_FWD = "rnnt_fwd"
KERNEL_BWD = "rnnt_bwd"
MAX_U1 = 1024   # one thread per label position, at most 1024 threads a block
RING = 8        # diagonals staged ahead of the chain, as the kernels' RING (rnnt_wavefront.cuh)
SMEM_LIMIT = 232448   # shared memory a block may use on the H100 (227 KB), as the kernels check


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(a, b)
    return m + torch.log1p(torch.exp(-(a - b).abs()))


def _diagonal(d: int, t_max: int, u1: int, device):
    """(t, u, valid) of the cells t + u = d of a (t_max, u1) lattice."""
    u = torch.arange(u1, device=device)
    t = d - u
    return t, u, (t >= 0) & (t < t_max)


def reference_rnnt_alphas(blank_lp: torch.Tensor, emit_lp: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the forward: the alphas (B, T, U+1) fp32 of
    the whole lattice, one anti-diagonal at a time."""
    blank_lp, emit_lp = blank_lp.float(), emit_lp.float()
    b, t_max, u1 = blank_lp.shape
    dev = blank_lp.device
    alphas = torch.empty((b, t_max, u1), dtype=torch.float32, device=dev)
    alphas[:, 0, 0] = 0.0
    neg = torch.full((b, 1), LOG_EPS, device=dev)
    for d in range(1, t_max + u1 - 1):
        t, u, valid = _diagonal(d, t_max, u1, dev)
        tc, uc = t[valid], u[valid]
        # stay: from (t-1, u); move: from (t, u-1); LOG_EPS off the lattice
        stay_ok = tc >= 1
        stay = torch.where(stay_ok, alphas[:, (tc - 1).clamp(min=0), uc]
                           + blank_lp[:, (tc - 1).clamp(min=0), uc], neg)
        move_ok = uc >= 1
        move = torch.where(move_ok, alphas[:, tc, (uc - 1).clamp(min=0)]
                           + emit_lp[:, tc, (uc - 1).clamp(min=0)], neg)
        alphas[:, tc, uc] = _logaddexp(stay, move)
    return alphas


def loss_from_alphas(alphas, blank_lp, f_len, y_len):
    """-(alpha + blank) at each utterance's terminal cell (pallas_rnnt.py:161-166)."""
    idx = torch.arange(alphas.shape[0], device=alphas.device)
    f_last, y = f_len.to(alphas.device).long() - 1, y_len.to(alphas.device).long()
    return -(alphas[idx, f_last, y] + blank_lp.float()[idx, f_last, y])


def reference_rnnt_grads(blank_lp, emit_lp, alphas, f_len, y_len, ll):
    """Plain PyTorch version of the backward: (d ll / d blank, d ll / d emit),
    each (B, T, U+1) fp32, the arithmetic of the TPU kernel's _bwd_kernel
    written out per cell: beta from each utterance's terminal cell down,
    beta[t+1, u] := 0 at that cell, LOG_EPS off the utterance's lattice,
    and exact zeros there in both gradients."""
    blank_lp, emit_lp = blank_lp.float(), emit_lp.float()
    b, t_max, u1 = blank_lp.shape
    dev = blank_lp.device
    f_len = f_len.to(dev).long()[:, None]
    y_len = y_len.to(dev).long()[:, None]
    ll = ll.to(dev).float()[:, None]
    g_blank = torch.empty((b, t_max, u1), dtype=torch.float32, device=dev)
    g_emit = torch.empty_like(g_blank)
    beta_next = torch.full((b, u1), LOG_EPS, device=dev)   # diagonal d + 1, by u
    eps_col = torch.full((b, 1), LOG_EPS, device=dev)
    zero = torch.zeros((), device=dev)
    for d in range(t_max + u1 - 2, -1, -1):
        t, u, valid = _diagonal(d, t_max, u1, dev)
        tc = t.clamp(0, t_max - 1)
        inside = valid[None] & (t[None] < f_len) & (u[None] <= y_len)
        final = (t[None] == f_len - 1) & (u[None] == y_len)
        a, bl, em = alphas[:, tc, u], blank_lp[:, tc, u], emit_lp[:, tc, u]
        beta_up = torch.cat([beta_next[:, 1:], eps_col], dim=1)        # beta[t, u+1]
        bn = torch.where(final, zero, beta_next)                       # beta[t+1, u]
        gb = torch.where(inside, torch.exp(a + bl + bn - ll), zero)
        ge = torch.where(inside, torch.exp(a + em + beta_up - ll), zero)
        beta = torch.where(final, bl, _logaddexp(bl + beta_next, em + beta_up))
        beta_next = torch.where(inside, beta, LOG_EPS)
        g_blank[:, t[valid], u[valid]] = gb[:, valid]
        g_emit[:, t[valid], u[valid]] = ge[:, valid]
    return g_blank, g_emit


def _check_lengths(f_len, y_len, b, t_max, u1):
    if f_len.shape != (b,) or y_len.shape != (b,):
        raise ValueError(f"rnnt: f_len {tuple(f_len.shape)} / y_len {tuple(y_len.shape)} "
                         f"are not ({b},)")
    ok = (f_len >= 1).all() & (f_len <= t_max).all() & (y_len >= 0).all() & (y_len < u1).all()
    msg = f"rnnt: lengths outside 1 <= f_len <= {t_max}, 0 <= y_len < {u1}"
    if f_len.device.type == "cpu" and y_len.device.type == "cpu":
        if not bool(ok):
            raise ValueError(msg)
    else:
        torch._assert_async(ok, msg)


def rnnt_alphas(blank_lp, emit_lp, f_len, y_len):
    """(alphas (B, T, U+1), per-utterance loss (B,)), both fp32: the plain
    version for CPU tensors, the kernel for CUDA tensors (counted in
    ``rnnt_alphas.launches``)."""
    if blank_lp.device.type == "cpu":
        alphas = reference_rnnt_alphas(blank_lp, emit_lp)
        return alphas, loss_from_alphas(alphas, blank_lp, f_len, y_len)
    if blank_lp.device.type != "cuda":
        raise ValueError(f"rnnt_alphas: no kernel for device {blank_lp.device}")
    out = _launch_fwd(blank_lp, emit_lp, f_len, y_len)
    rnnt_alphas.launches += 1
    return out


rnnt_alphas.launches = 0  # forward kernel launches since the caller last reset it


def rnnt_grads(blank_lp, emit_lp, alphas, f_len, y_len, ll):
    """(d ll / d blank, d ll / d emit): the plain version for CPU tensors, the
    two kernels for CUDA tensors, the betas then the gradients (each counted
    in ``rnnt_grads.launches``)."""
    if blank_lp.device.type == "cpu":
        return reference_rnnt_grads(blank_lp, emit_lp, alphas, f_len, y_len, ll)
    if blank_lp.device.type != "cuda":
        raise ValueError(f"rnnt_grads: no kernel for device {blank_lp.device}")
    out = _launch_bwd(blank_lp, emit_lp, alphas, f_len, y_len, ll)
    rnnt_grads.launches += 2
    return out


rnnt_grads.launches = 0  # backward kernel launches (two a call) since the caller last reset it


class _RNNTLoss(torch.autograd.Function):
    """Per-utterance NLL of the gathered log-probs. The forward saves the
    alphas; the backward runs the beta recursion and scales both gradients
    by the incoming cotangent with the loss's sign (pallas_rnnt.py:198-201)."""

    @staticmethod
    def forward(ctx, blank_lp, emit_lp, f_len, y_len):
        alphas, loss = rnnt_alphas(blank_lp, emit_lp, f_len, y_len)
        ctx.save_for_backward(blank_lp, emit_lp, alphas, f_len, y_len, loss)
        return loss

    @staticmethod
    def backward(ctx, g):
        blank_lp, emit_lp, alphas, f_len, y_len, loss = ctx.saved_tensors
        g_blank, g_emit = rnnt_grads(blank_lp, emit_lp, alphas, f_len, y_len, -loss)
        scale = -g.float()[:, None, None]
        return ((g_blank * scale).to(blank_lp.dtype), (g_emit * scale).to(emit_lp.dtype),
                None, None)


def rnnt_loss_from_gathered(blank_lp, emit_lp, f_len, y_len) -> torch.Tensor:
    """Per-utterance negative log likelihood (B,) from the gathered blank
    and emit log-probs (B, T, U+1); f_len and y_len (B,) on the host or on
    the log-probs' device."""
    b, t_max, u1 = blank_lp.shape
    _check_lengths(f_len, y_len, b, t_max, u1)
    dev = blank_lp.device
    f_len = f_len.to(dev, torch.int32)
    y_len = y_len.to(dev, torch.int32)
    return _RNNTLoss.apply(blank_lp, emit_lp, f_len, y_len)


def rnnt_loss(logits: torch.Tensor, labels: torch.Tensor, f_len: torch.Tensor,
              y_len: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """Per-utterance RNN-T negative log likelihood (B,) from the joint
    logits (B, T, U+1, V) and 0-padded labels (B, U). Only the fp32
    log-normaliser (B, T, U+1) and the two gathered rows are formed
    (rnnt_loss.py:96-104); no (B, T, U+1, V) log-softmax is."""
    v = logits.shape[-1]
    inside = torch.arange(labels.shape[1], device=labels.device)[None, :] < y_len.to(
        labels.device)[:, None]
    in_range = ((labels >= 1) & (labels < v)) | ~inside
    if labels.device.type == "cpu":
        if not bool(in_range.all()):
            raise ValueError(f"rnnt_loss: labels outside [1, {v}) within y_len")
    else:
        torch._assert_async(in_range.all(), f"rnnt_loss: labels outside [1, {v}) within y_len")
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1)
    blank_lp = x[..., blank] - lse
    # labels past y_len are never read; the last column is a dummy
    lab = F.pad(torch.where(inside, labels, 0).long(), (0, 1))
    idx = lab[:, None, :, None].expand(-1, x.shape[1], -1, 1)
    emit_lp = x.gather(3, idx)[..., 0] - lse
    return rnnt_loss_from_gathered(blank_lp, emit_lp, f_len, y_len)


# ---------------------------------------------------------------- launch


def launch_geometry(u1: int) -> tuple[int, int, int]:
    """(threads, ring, shared bytes) of one block of either kernel at
    U+1 = u1: one thread per label position, rounded up to whole warps; a
    ring of RING diagonals of the two staged operands (blank and emit), one
    fp32 slot per thread each; and 2 x 32 slots that carry a value a
    diagonal across each warp boundary."""
    if not 1 <= u1 <= MAX_U1:
        raise ValueError(f"rnnt: U+1 = {u1} outside [1, {MAX_U1}] label positions")
    threads = -(-u1 // 32) * 32
    return threads, RING, 4 * (2 * 32 + RING * 2 * threads)


def _bind(lib: ctypes.CDLL, name: str, n_ptr: int):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ecf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ecf_cuda_error_string.restype = ctypes.c_char_p
    return fn


def _checked(name, blank_lp, emit_lp, *others):
    b, t_max, u1 = blank_lp.shape
    if emit_lp.shape != blank_lp.shape:
        raise ValueError(f"{name}: emit {tuple(emit_lp.shape)} != blank {tuple(blank_lp.shape)}")
    if u1 > MAX_U1:
        raise ValueError(f"{name}: U+1 = {u1} > {MAX_U1} label positions")
    if any(t.device != blank_lp.device for t in (emit_lp, *others)):
        raise ValueError(f"{name}: tensors lie on different devices")
    return b, t_max, u1


def _raise_on(err: int, lib, kernel: str):
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: "
                           f"{lib.ecf_cuda_error_string(err).decode()} ({err})")


def _launch_fwd(blank_lp, emit_lp, f_len, y_len):
    b, t_max, u1 = _checked("rnnt_alphas", blank_lp, emit_lp, f_len, y_len)
    blank_lp, emit_lp = (x.float().contiguous() for x in (blank_lp, emit_lp))
    f_len, y_len = (x.to(torch.int32).contiguous() for x in (f_len, y_len))
    lib = _kernels.load(KERNEL_FWD)
    fn = _bind(lib, "ecf_rnnt_fwd", 6)
    alphas = torch.empty((b, t_max, u1), dtype=torch.float32, device=blank_lp.device)
    loss = torch.empty((b,), dtype=torch.float32, device=blank_lp.device)
    with torch.cuda.device(blank_lp.device):
        stream = torch.cuda.current_stream(blank_lp.device).cuda_stream
        err = fn(blank_lp.data_ptr(), emit_lp.data_ptr(), f_len.data_ptr(), y_len.data_ptr(),
                 alphas.data_ptr(), loss.data_ptr(), b, t_max, u1, *launch_geometry(u1), stream)
    _raise_on(err, lib, KERNEL_FWD)
    return alphas, loss


def _launch_bwd(blank_lp, emit_lp, alphas, f_len, y_len, ll):
    b, t_max, u1 = _checked("rnnt_grads", blank_lp, emit_lp, alphas, f_len, y_len, ll)
    if alphas.shape != blank_lp.shape or ll.shape != (b,):
        raise ValueError("rnnt_grads: alphas / ll do not match the log-probs")
    blank_lp, emit_lp, alphas, ll = (x.float().contiguous()
                                     for x in (blank_lp, emit_lp, alphas, ll))
    f_len, y_len = (x.to(torch.int32).contiguous() for x in (f_len, y_len))
    lib = _kernels.load(KERNEL_BWD)
    fn = _bind(lib, "ecf_rnnt_bwd", 9)
    g_blank = torch.empty((b, t_max, u1), dtype=torch.float32, device=blank_lp.device)
    g_emit = torch.empty_like(g_blank)
    betas = torch.empty_like(g_blank)   # scratch: the kernel's betas inside each lattice
    with torch.cuda.device(blank_lp.device):
        stream = torch.cuda.current_stream(blank_lp.device).cuda_stream
        err = fn(blank_lp.data_ptr(), emit_lp.data_ptr(), alphas.data_ptr(), f_len.data_ptr(),
                 y_len.data_ptr(), ll.data_ptr(), g_blank.data_ptr(), g_emit.data_ptr(),
                 betas.data_ptr(), b, t_max, u1, *launch_geometry(u1), stream)
    _raise_on(err, lib, KERNEL_BWD)
    return g_blank, g_emit
