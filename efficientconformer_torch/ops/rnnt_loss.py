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

The kernels take any U+1 (``launch_geometry``): up to MAX_THREADS label
positions one thread each, past them a strip of STRIPS positions a thread
in registers, and past STRIP_MAX x MAX_THREADS a wider strip whose last
diagonal is read back from the kernel's output (csrc/rnnt_wavefront.cuh).

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
# the kernels' compile-time constants (csrc/rnnt_wavefront.cuh)
MAX_THREADS = 1024   # threads a block: one per label position up to this U+1
RING = 8             # diagonals staged ahead of the chain (the most, past MAX_THREADS)
SMEM_LIMIT = 232448  # shared memory a block may use on the H100 (227 KB), as the kernels check
EDGE = 64            # fp32 slots that carry a value a diagonal across each warp boundary
STRIPS = (2, 4, 8)   # label positions a thread holds in registers past MAX_THREADS
STRIP_MAX = STRIPS[-1]


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(a, b)
    return m + torch.log1p(torch.exp(-(a - b).abs()))


def _diagonal(x: torch.Tensor, d: int, lo: int, hi: int, shift: int = 0) -> torch.Tensor:
    """The cells (d - u, u), u = hi down to lo, of a contiguous (B, T', U')
    tensor as a strided view (B, hi - lo + 1), each moved ``shift`` elements
    along its row-major storage: -U' is the cell above, -1 the one to the
    left. No gather and no mask read back from the device."""
    b, t_, u_ = x.shape
    return x.as_strided((b, hi - lo + 1), (t_ * u_, u_ - 1),
                        x.storage_offset() + (d - hi) * u_ + hi + shift)


def reference_rnnt_alphas(blank_lp: torch.Tensor, emit_lp: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the forward: the alphas (B, T, U+1) fp32 of
    the whole lattice, one anti-diagonal at a time."""
    blank_lp, emit_lp = blank_lp.float().contiguous(), emit_lp.float().contiguous()
    b, t_max, u1 = blank_lp.shape
    dev = blank_lp.device
    alphas = torch.empty((b, t_max, u1), dtype=torch.float32, device=dev)
    alphas[:, 0, 0] = 0.0
    for d in range(1, t_max + u1 - 1):
        lo, hi = max(0, d - t_max + 1), min(d, u1 - 1)   # the diagonal's cells, u = hi .. lo
        # stay: from (t-1, u); move: from (t, u-1); LOG_EPS off the lattice
        # (at the diagonal's cell t = 0, first, and u = 0, last)
        stay = torch.full((b, hi - lo + 1), LOG_EPS, device=dev)
        move = torch.full_like(stay, LOG_EPS)
        first = int(hi == d)
        if hi - first >= lo:
            stay[:, first:] = (_diagonal(alphas, d, lo, hi - first, -u1)
                               + _diagonal(blank_lp, d, lo, hi - first, -u1))
        if hi >= max(lo, 1):
            move[:, :hi - max(lo, 1) + 1] = (_diagonal(alphas, d, max(lo, 1), hi, -1)
                                             + _diagonal(emit_lp, d, max(lo, 1), hi, -1))
        _diagonal(alphas, d, lo, hi).copy_(_logaddexp(stay, move))
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
    one anti-diagonal at a time, LOG_EPS off the utterance's lattice; then
    both gradients of every cell, beta[t+1, u] := 0 at the terminal cell,
    and exact zeros off the lattice."""
    blank_lp, emit_lp = blank_lp.float().contiguous(), emit_lp.float().contiguous()
    alphas = alphas.float()
    b, t_max, u1 = blank_lp.shape
    dev = blank_lp.device
    f_len = f_len.to(dev).long()[:, None]
    y_len = y_len.to(dev).long()[:, None]
    ll = ll.to(dev).float()[:, None, None]
    # the betas, with a row below and a column right of LOG_EPS: beta[t+1, u]
    # and beta[t, u+1] of every cell lie inside it
    betas = torch.full((b, t_max + 1, u1 + 1), LOG_EPS, device=dev)
    u_down = torch.arange(u1 - 1, -1, -1, device=dev)     # u of a diagonal's cells, from hi
    zero = torch.zeros((), device=dev)
    for d in range(t_max + u1 - 2, -1, -1):
        lo, hi = max(0, d - t_max + 1), min(d, u1 - 1)
        u = u_down[u1 - 1 - hi:u1 - lo]
        t = d - u
        inside = (t[None] < f_len) & (u[None] <= y_len)
        final = (t[None] == f_len - 1) & (u[None] == y_len)
        bl, em = _diagonal(blank_lp, d, lo, hi), _diagonal(emit_lp, d, lo, hi)
        below = _diagonal(betas, d, lo, hi, u1 + 1)            # beta[t+1, u]
        right = _diagonal(betas, d, lo, hi, 1)                 # beta[t, u+1]
        beta = torch.where(final, bl, _logaddexp(bl + below, em + right))
        _diagonal(betas, d, lo, hi).copy_(torch.where(inside, beta, LOG_EPS))
    t = torch.arange(t_max, device=dev)[None, :, None]
    u = torch.arange(u1, device=dev)[None, None, :]
    inside = (t < f_len[:, :, None]) & (u <= y_len[:, :, None])
    final = (t == f_len[:, :, None] - 1) & (u == y_len[:, :, None])
    below = torch.where(final, zero, betas[:, 1:, :u1])
    g_blank = torch.where(inside, torch.exp(alphas + blank_lp + below - ll), zero)
    g_emit = torch.where(inside, torch.exp(alphas + emit_lp + betas[:, :t_max, 1:] - ll), zero)
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
    ``rnnt_alphas.launches``, and those with a strip of label positions a
    thread also in ``rnnt_alphas.strip_launches``)."""
    if blank_lp.device.type == "cpu":
        alphas = reference_rnnt_alphas(blank_lp, emit_lp)
        return alphas, loss_from_alphas(alphas, blank_lp, f_len, y_len)
    if blank_lp.device.type != "cuda":
        raise ValueError(f"rnnt_alphas: no kernel for device {blank_lp.device}")
    alphas, loss, strip = _launch_fwd(blank_lp, emit_lp, f_len, y_len)
    rnnt_alphas.launches += 1
    rnnt_alphas.strip_launches += int(strip > 1)
    return alphas, loss


rnnt_alphas.launches = 0  # forward kernel launches since the caller last reset it
rnnt_alphas.strip_launches = 0   # of them, past one thread a label position


def rnnt_grads(blank_lp, emit_lp, alphas, f_len, y_len, ll):
    """(d ll / d blank, d ll / d emit): the plain version for CPU tensors, the
    two kernels for CUDA tensors, the betas then the gradients (each counted
    in ``rnnt_grads.launches``; the betas with a strip of label positions a
    thread also in ``rnnt_grads.strip_launches``)."""
    if blank_lp.device.type == "cpu":
        return reference_rnnt_grads(blank_lp, emit_lp, alphas, f_len, y_len, ll)
    if blank_lp.device.type != "cuda":
        raise ValueError(f"rnnt_grads: no kernel for device {blank_lp.device}")
    g_blank, g_emit, strip = _launch_bwd(blank_lp, emit_lp, alphas, f_len, y_len, ll)
    rnnt_grads.launches += 2
    rnnt_grads.strip_launches += int(strip > 1)
    return g_blank, g_emit


rnnt_grads.launches = 0  # backward kernel launches (two a call) since the caller last reset it
rnnt_grads.strip_launches = 0   # of them, the betas past one thread a label position


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


def launch_geometry(u1: int) -> tuple[int, int, int, int]:
    """(threads, strip, ring, shared bytes) of one block of either kernel at
    U+1 = u1, as the C entry points check it (rnnt_wavefront.cuh).

    Each thread owns ``strip`` consecutive label positions, the fewest that
    let at most MAX_THREADS threads cover u1: 1 up to MAX_THREADS, then 2, 4
    or 8 (held in registers), then any wider strip. Threads are whole
    warps, as few as cover u1 at that strip. The ring stages RING diagonals
    of the two operands (blank and emit), one fp32 slot per position each;
    past MAX_THREADS it is as deep as SMEM_LIMIT allows (RING down to 1),
    and the strips wider than STRIP_MAX have none: their kernels read the
    last diagonal back from their output. Shared memory holds the ring and
    EDGE slots (csrc/rnnt_wavefront.cuh: smem_bytes)."""
    if u1 < 1:
        raise ValueError(f"rnnt: U+1 = {u1}: a lattice needs at least 1 label position")
    strip = next((k for k in (1, *STRIPS) if k * MAX_THREADS >= u1), -(-u1 // MAX_THREADS))
    strips = -(-u1 // strip)
    threads = -(-strips // 32) * 32
    if strip == 1:
        ring = RING
    elif strip <= STRIP_MAX:
        ring = min(RING, (SMEM_LIMIT - 4 * EDGE) // (4 * 2 * strip * threads))
    else:
        ring = 0
    return threads, strip, ring, 4 * (EDGE + ring * 2 * strip * threads)


def _bind(lib: ctypes.CDLL, name: str, n_ptr: int):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ecf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ecf_cuda_error_string.restype = ctypes.c_char_p
    return fn


def _checked(name, blank_lp, emit_lp, *others):
    b, t_max, u1 = blank_lp.shape
    if emit_lp.shape != blank_lp.shape:
        raise ValueError(f"{name}: emit {tuple(emit_lp.shape)} != blank {tuple(blank_lp.shape)}")
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
    geometry = launch_geometry(u1)
    with torch.cuda.device(blank_lp.device):
        stream = torch.cuda.current_stream(blank_lp.device).cuda_stream
        err = fn(blank_lp.data_ptr(), emit_lp.data_ptr(), f_len.data_ptr(), y_len.data_ptr(),
                 alphas.data_ptr(), loss.data_ptr(), b, t_max, u1, *geometry, stream)
    _raise_on(err, lib, KERNEL_FWD)
    return alphas, loss, geometry[1]


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
    geometry = launch_geometry(u1)
    with torch.cuda.device(blank_lp.device):
        stream = torch.cuda.current_stream(blank_lp.device).cuda_stream
        err = fn(blank_lp.data_ptr(), emit_lp.data_ptr(), alphas.data_ptr(), f_len.data_ptr(),
                 y_len.data_ptr(), ll.data_ptr(), g_blank.data_ptr(), g_emit.data_ptr(),
                 betas.data_ptr(), b, t_max, u1, *geometry, stream)
    _raise_on(err, lib, KERNEL_BWD)
    return g_blank, g_emit, geometry[1]
