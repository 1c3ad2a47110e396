"""Audio frontend: STFT -> mel filterbank -> log.

Counterpart of efficientconformer_tpu/ops/audio.py: reflect-centred
n_fft-point frames, a periodic Hann window of win_length zero-padded to
n_fft, the power spectrum from a real DFT written as one matmul, an HTK-scale
triangular mel filterbank over 0-8000 Hz without normalisation, then
log(x + 1e-9), all in fp32. Output layout is (B, frames, n_mels).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def hann_window_padded(win_length: int, n_fft: int) -> np.ndarray:
    """Periodic Hann window of win_length, centred in an n_fft buffer."""
    n = np.arange(win_length)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    left = (n_fft - win_length) // 2
    out = np.zeros(n_fft)
    out[left : left + win_length] = w
    return out


@functools.lru_cache(maxsize=8)
def dft_matrices(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-input DFT as two (n_fft, n_fft//2+1) matmul operands (cos, -sin)."""
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    n_freqs: int, n_mels: int, sample_rate: int, f_min: float, f_max: float
) -> np.ndarray:
    """(n_freqs, n_mels) HTK-scale triangular filterbank, no normalisation."""

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    f_pts = mel_to_hz(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]                      # (n_mels + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]          # (n_freqs, n_mels + 2)
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _frontend_matrices(win_length: int, n_fft: int, n_mels: int, sample_rate: int,
                       device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(windowed DFT (n_fft, 2*(n_fft//2+1)) = diag(window) [cos | -sin],
    mel filterbank (n_fft//2+1, n_mels)), fp32 on ``device``."""
    cos_m, sin_m = dft_matrices(n_fft)
    window = hann_window_padded(win_length, n_fft)[:, None]
    dft = np.concatenate([cos_m, sin_m], axis=1) * window
    fb = mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate, 0.0, 8000.0)
    return (torch.as_tensor(dft, dtype=torch.float32, device=device),
            torch.as_tensor(fb, device=device))


def log_mel_spectrogram(
    x: torch.Tensor,
    x_len: torch.Tensor | None,
    *,
    sample_rate: int = 16000,
    n_fft: int = 512,
    win_length_ms: int = 25,
    hop_length_ms: int = 10,
    n_mels: int = 80,
    normalize: bool = False,
    mean: float = 0.0,
    std: float = 1.0,
):
    """(B, T_audio) waveform -> ((B, T_audio//hop + 1, n_mels) fp32, lengths).

    frames = T//hop + 1 and x_len -> x_len//hop + 1, as in the JAX package.
    """
    win_length = sample_rate * win_length_ms // 1000
    hop = sample_rate * hop_length_ms // 1000
    pad = n_fft // 2
    xp = F.pad(x.to(torch.float32)[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = xp.unfold(1, n_fft, hop)                     # (B, T//hop + 1, n_fft)
    dft, fb = _frontend_matrices(win_length, n_fft, n_mels, sample_rate, x.device)
    spec = frames @ dft                                   # [re | im] of windowed frames
    n_freqs = n_fft // 2 + 1
    re, im = spec[..., :n_freqs], spec[..., n_freqs:]
    mel = (re * re + im * im) @ fb                        # (B, nF, n_mels)
    out = torch.log(mel + 1e-9)
    if normalize:
        out = (out - mean) / std
    if x_len is not None:
        x_len = x_len // hop + 1
    return out, x_len
