"""SpecAugment: frequency and adaptive time masks on log-mel features.

Counterpart of efficientconformer_tpu/ops/specaugment.py, split in two so
that a test can feed both packages the same random numbers:

  * ``draw`` takes the uniforms from a ``torch.Generator`` on the features'
    device: (mF,) width and start draws of the frequency masks, shared by the
    batch, and (B, mT) width and start draws of the time masks, per sample;
  * ``apply`` turns them into masks exactly as the JAX package does:
    frequency width U[0, F), start U[0, n_mels - width); time width
    U[0, pS * x_len_b), start U[0, x_len_b - width), so that time masks fall
    within each sample's valid frames. Masked cells are set to 0.
"""

from __future__ import annotations

import torch


def draw(generator: torch.Generator, batch: int, mF: int, mT: int) -> tuple:
    """(freq widths, freq starts, time widths, time starts) uniforms in [0, 1)."""
    dev = generator.device

    def u(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    return u(mF), u(mF), u(batch, mT), u(batch, mT)


def apply(x: torch.Tensor, x_len: torch.Tensor, uniforms: tuple, *, F: int,
          pS: float) -> torch.Tensor:
    """x (B, T, M) features, x_len (B,) -> x with the masked cells set to 0."""
    _, t, m = x.shape
    fw_u, fs_u, tw_u, ts_u = uniforms
    widths = fw_u * F
    starts = fs_u * (m - widths)
    freqs = torch.arange(m, dtype=torch.float32, device=x.device)
    fmask = ((freqs[None, :] >= starts[:, None])
             & (freqs[None, :] < (starts + widths)[:, None])).any(dim=0)      # (M,)
    length = x_len.to(torch.float32)
    widths = tw_u * (pS * length)[:, None]
    starts = ts_u * (length[:, None] - widths)
    times = torch.arange(t, dtype=torch.float32, device=x.device)
    tmask = ((times[None, None, :] >= starts[:, :, None])
             & (times[None, None, :] < (starts + widths)[:, :, None])).any(dim=1)  # (B, T)
    mask = fmask[None, None, :] | tmask[:, :, None]
    return x.masked_fill(mask, 0.0)


def spec_augment(x, x_len, generator: torch.Generator, *, mF: int, F: int, mT: int,
                 pS: float) -> torch.Tensor:
    return apply(x, x_len, draw(generator, x.shape[0], mF, mT), F=F, pS=pS)
