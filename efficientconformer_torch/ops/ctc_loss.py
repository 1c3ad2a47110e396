"""CTC loss: the per-sample negative log likelihood, blank id 0.

Counterpart of efficientconformer_tpu/ops/ctc_loss.py (an alpha recursion in
log space, never a Pallas kernel), computed here by torch's own
``F.ctc_loss`` with ``reduction="none"``. Shapes follow the JAX package:
log_probs (B, T, V) float, labels (B, U) int 0-padded, f_len (B,), y_len
(B,). Frames past f_len and labels past y_len are ignored; y_len = 0 gives
the all-blank path.

Labels inside y_len must lie in [1, V): the JAX loss turns an out-of-range
label into a zero emission instead of an error, the port refuses it (on the
host for CPU labels, with a device-side assert for labels on the card, which
costs no synchronisation).

An infeasible lattice (f_len too short for the labels and their repeats)
gives +inf here, where the JAX recursion gives about 1e30.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
    return F.ctc_loss(log_probs.transpose(0, 1), labels.long(), f_len.long(), y_len.long(),
                      blank=0, reduction="none", zero_infinity=False)
