"""CTC loss: the per-sample negative log likelihood, blank id 0.

Counterpart of efficientconformer_tpu/ops/ctc_loss.py (an alpha recursion in
log space, never a Pallas kernel). Shapes follow the JAX package: log_probs
(B, T, V) float, labels (B, U) int 0-padded, f_len (B,), y_len (B,). Frames
past f_len and labels past y_len are ignored; y_len = 0 gives the all-blank
path.

Labels inside y_len must lie in [1, V): the JAX loss turns an out-of-range
label into a zero emission instead of an error, the port refuses it (on the
host for CPU labels, with a device-side assert for labels on the card, which
costs no synchronisation).

A feasible row (f_len >= y_len + the number of adjacent repeated labels,
each repeat needing a blank between) goes through torch's own
``F.ctc_loss`` with ``reduction="none"``. An infeasible row has no path:
``F.ctc_loss`` would give +inf and a non-finite gradient, which the batch
mean would carry into every weight. Those rows go through ``_jax_recursion``
instead, a plain PyTorch copy of the JAX recursion with its floor LOG_EPS =
-1e30 and its ``logaddexp`` (value and gradient): a loss of about 1e30 and
a finite gradient, as the JAX package gives. Feasibility is decided on the
host without a synchronisation when labels, f_len and y_len lie on the
host (``Trainer.train_step`` hands the loss host copies, read before the
step's work is queued); when any of them lies on the card, the infeasible
rows and their frame counts are copied back once per call, the loss's only
synchronisation, which waits for the forward pass queued before it.
Labels on the host go to the card without a synchronisation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LOG_EPS = -1e30


class _LogAddExp(torch.autograd.Function):
    """jnp.logaddexp: amax + log1p(exp(-|x1 - x2|)), x1 + x2 where the
    difference is NaN; its gradient g * exp(x - out) on each side (JAX's
    custom JVP), which on two equal floors gives 1 to each, not 1/2."""

    @staticmethod
    def forward(ctx, x1, x2):
        delta = x1 - x2
        out = torch.where(torch.isnan(delta), x1 + x2,
                          torch.maximum(x1, x2) + torch.log1p(torch.exp(-delta.abs())))
        ctx.save_for_backward(x1, x2, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x1, x2, out = ctx.saved_tensors

        def no_inf(x):
            return torch.where(x == float("inf"), torch.zeros_like(x), x)

        o = no_inf(out)
        return g * torch.exp(no_inf(x1) - o), g * torch.exp(no_inf(x2) - o)


def _jax_recursion(log_probs, labels, f_len, y_len, t_max):
    """efficientconformer_tpu/ops/ctc_loss.py:37-88 in PyTorch: the alpha
    recursion over the extended labels, frames 1 .. t_max - 1, (B,)."""
    lae = _LogAddExp.apply
    b, _, _ = log_probs.shape
    dev = log_probs.device
    u = labels.shape[1]
    s = 2 * u + 1
    ext = torch.zeros((b, s), dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    prev2 = torch.cat([torch.zeros((b, 2), dtype=torch.long, device=dev), ext[:, :-2]], 1)
    can_skip = (torch.arange(s, device=dev) % 2 == 1)[None, :] & (ext != prev2)
    skip_mask = torch.where(can_skip, 0.0, LOG_EPS)
    state_valid = torch.arange(s, device=dev)[None, :] < (2 * y_len + 1)[:, None]
    emit = torch.gather(log_probs, 2, ext[:, None, :].expand(b, log_probs.shape[1], s))
    floor = torch.full((b, s), LOG_EPS, device=dev)
    alpha = torch.cat([emit[:, 0, :1],
                       torch.where(y_len > 0, emit[:, 0, 1], LOG_EPS)[:, None],
                       floor[:, 2:]], 1)
    for t in range(1, t_max):
        diag = torch.cat([floor[:, :1], alpha[:, :-1]], 1)
        skip = torch.cat([floor[:, :2], alpha[:, :-2]], 1) + skip_mask
        new = lae(lae(alpha, diag), skip) + emit[:, t]
        new = torch.where(state_valid, new, floor)
        alpha = torch.where((t < f_len)[:, None], new, alpha)
    last = 2 * y_len
    final_blank = torch.gather(alpha, 1, last[:, None])[:, 0]
    final_label = torch.gather(alpha, 1, (last - 1).clamp(min=0)[:, None])[:, 0]
    final_label = torch.where(y_len > 0, final_label, LOG_EPS)
    return -lae(final_blank, final_label)


def ctc_loss(log_probs: torch.Tensor, labels: torch.Tensor, f_len: torch.Tensor,
             y_len: torch.Tensor) -> torch.Tensor:
    """Per-sample CTC negative log likelihood with blank 0, shape (B,)."""
    v = log_probs.shape[-1]
    inside = torch.arange(labels.shape[1], device=labels.device)[None, :] < y_len.to(
        labels.device)[:, None]
    in_range = ((labels >= 1) & (labels < v)) | ~inside
    if labels.device.type == "cpu":
        if not bool(in_range.all()):
            raise ValueError(f"ctc_loss: labels outside [1, {v}) within y_len")
    else:
        torch._assert_async(in_range.all(), f"ctc_loss: labels outside [1, {v}) within y_len")
    repeats = ((labels[:, 1:] == labels[:, :-1]) & inside[:, 1:]).sum(1)
    f_dev = f_len.to(labels.device).long()
    # the infeasible rows and their frame counts, in one copy to the host:
    # the one synchronisation, when any of the three lies on the card
    host = torch.stack([f_dev < y_len.to(labels.device).long() + repeats, f_dev]).cpu()
    f_len, y_len = f_len.long(), y_len.long()
    dev = log_probs.device
    labels = labels.long().to(dev, non_blocking=True)
    if not bool(host[0].any()):
        return F.ctc_loss(log_probs.transpose(0, 1), labels, f_len, y_len,
                          blank=0, reduction="none", zero_infinity=False)
    rows = host[0].nonzero()[:, 0]
    feasible_y = torch.where(host[0].bool().to(y_len.device), 0, y_len)  # an all-blank stand-in
    loss = F.ctc_loss(log_probs.transpose(0, 1), labels, f_len, feasible_y,
                      blank=0, reduction="none", zero_infinity=False)
    idx = rows.to(dev, non_blocking=True)
    jax_rows = _jax_recursion(log_probs[idx], labels[idx], f_len.to(dev, non_blocking=True)[idx],
                              y_len.to(dev, non_blocking=True)[idx],
                              max(int(host[1][rows].max()), 1))
    return loss.index_put((idx,), jax_rows)
