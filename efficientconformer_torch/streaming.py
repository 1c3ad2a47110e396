"""Chunked streaming inference (overlap-save).

Counterpart of efficientconformer_tpu/streaming.py. A session runs an
unchanged encoder over overlapping windows of a fixed size: output frame j
of the encoder is aligned to mel frame j * S (S mel frames per output
frame, ``total_stride``), and mel frame m is centred at sample m * hop, so a
window that starts at output frame ``base`` computes output frames base ..
base + W. Of each window only the interior ``chunk`` frames are emitted:
``history`` frames of left margin re-establish the attention and conv
context, ``lookahead`` frames of right margin absorb the subsampling convs'
right context and the STFT's edge.

Exactness: the emitted frames equal the batch forward on the zero-padded
utterance once ``history`` covers the encoder's left receptive field
(``suggested_history_frames``) and ``lookahead`` its right one
(``suggested_lookahead_frames``). Causal encoders have a right field of 0;
non-causal ones with a finite ``right_context`` are exact at a fixed delay
of ``suggested_lookahead_frames``. Full-context encoders (every shipped
config) have an unbounded right field, so streaming them is approximate.

Window starts are rounded down to keep every grouped attention stage's
tiling phase that of the whole-utterance forward (``_base_alignment``).

The rolling window lives on the session's device: each step uploads only
the new samples and shifts the device buffer. Decoding is incremental:
``StreamingCTC`` carries the previous non-blank across windows,
``StreamingTransducer`` the greedy state of
models/transducer.greedy_decode_stream.

The session runs on the card unless the caller names another device, and
raises without one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from efficientconformer_torch.config import (
    default_device,
    encoder_output_frames,
    resolve_block_configs,
)

# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def _strides_per_stage(p: dict) -> list[int]:
    """The cumulative block stride (in subsampled frames) entering each
    block."""
    s = 1
    out = []
    for b in resolve_block_configs(p):
        out.append(s)
        if b.stride > 1:
            s *= b.stride
    return out


def total_stride(p: dict) -> int:
    """Mel frames per encoder output frame (subsampling x block strides)."""
    s = 2 ** p.get("subsampling_layers", 1)
    for b in resolve_block_configs(p):
        if b.stride > 1:
            s *= b.stride
    return s


def _base_alignment(p: dict) -> int:
    """The multiple of output frames a window start must be, to keep every
    grouped attention stage's tiling phase: base * ratio = 0 (mod G), with
    ratio the stage frames per output frame."""
    sub = 2 ** p.get("subsampling_layers", 1)
    s_out_mel = total_stride(p)
    align = 1
    for b, s_in in zip(resolve_block_configs(p), _strides_per_stage(p)):
        ratio = s_out_mel // (sub * s_in)
        for tile in (b.att_group_size, b.att_kernel_size or 1):
            if tile and tile > 1:
                align = math.lcm(align, tile // math.gcd(tile, ratio))
    return align


def suggested_lookahead_frames(p: dict) -> int:
    """The encoder's right receptive field in output frames: the retained
    lookahead at which a non-causal encoder streams exactly. Per block the
    attention's right context, the grouped tiling's spill (G - 1) and the
    conv's right half, at that block's frame rate, plus the subsampling
    stack's and the STFT's margin. 0 for a causal encoder; of the order of
    max_pos_encoding for a full-context one."""
    if p.get("causal", False):
        return 0
    sub = 2 ** p.get("subsampling_layers", 1)
    s_out_mel = total_stride(p)
    right_att = p.get("right_context", p["max_pos_encoding"])
    total_mel = 2 * sub
    for b, s_in in zip(resolve_block_configs(p), _strides_per_stage(p)):
        right_ext = right_att + b.kernel_size // 2
        for tile in (b.att_group_size, b.att_kernel_size or 1):
            if tile and tile > 1:
                right_ext += tile - 1
        total_mel += right_ext * sub * s_in
    return -(-total_mel // s_out_mel)


def suggested_history_frames(p: dict) -> int:
    """The encoder's left receptive field in output frames: per block the
    attention's left context (``left_context``, full by default) plus the
    conv kernel, at that block's frame rate, plus the subsampling stack's."""
    sub = 2 ** p.get("subsampling_layers", 1)
    s_out_mel = total_stride(p)
    left_att = p.get("left_context", p["max_pos_encoding"])
    total_mel = 2 * sub
    for b, s_in in zip(resolve_block_configs(p), _strides_per_stage(p)):
        total_mel += (left_att + b.kernel_size) * sub * s_in
    return -(-total_mel // s_out_mel)


class WindowGeometry:
    """The window sizes of a session or a server: history and chunk rounded
    up to the tiling alignment, so that the window start advances by
    exactly one chunk a step, and their sizes in samples."""

    def __init__(self, p: dict, chunk_frames: int, history_frames: Optional[int],
                 lookahead_frames: int):
        self.hop = p["sample_rate"] * p["hop_length_ms"] // 1000
        self.stride = total_stride(p)
        self.samples_per_frame = self.hop * self.stride
        self.align = _base_alignment(p)
        if history_frames is None:
            history_frames = suggested_history_frames(p)
        self.history_frames = -(-history_frames // self.align) * self.align
        self.chunk_frames = -(-chunk_frames // self.align) * self.align
        self.lookahead_frames = lookahead_frames
        self.window_frames = self.history_frames + self.chunk_frames + lookahead_frames
        self.window_samples = (self.window_frames * self.stride - 1) * self.hop
        self.chunk_samples = self.chunk_frames * self.samples_per_frame

    def base(self, emitted: int) -> int:
        """The start (in output frames) of the window that emits from
        ``emitted`` on."""
        b = max(0, emitted - self.history_frames)
        return (b // self.align) * self.align

    def need(self, base: int) -> int:
        """The absolute sample count the window at ``base`` covers."""
        return base * self.samples_per_frame + self.window_samples

    def emit_end(self, base: int, total_out: Optional[int]) -> int:
        """The local end of the frames the window at ``base`` emits: up to
        the lookahead, or the stream's last frame in its final window."""
        if total_out is not None and base + self.window_frames >= total_out:
            return total_out - base
        return self.window_frames - self.lookahead_frames


# ---------------------------------------------------------------------------
# encoder session
# ---------------------------------------------------------------------------


@dataclass
class Emission:
    """One window's encoder output: ``frames`` is the device tensor of the
    whole window (B, window_frames, ...); the new frames are the local range
    [first, last), at absolute output frame ``start``. ``valid`` fetches
    only those to the host."""

    frames: torch.Tensor
    first: int
    last: int
    start: int

    @property
    def valid(self) -> np.ndarray:
        out = self.frames[:, self.first:self.last]
        return (out.float() if out.is_floating_point() else out).cpu().numpy()


class StreamingEncoderSession:
    """Overlap-save streaming around an encoder function
    ``encode_fn(audio (B, T), x_len (B,)) -> frames | (frames, ...)``, both
    tensors on the session's device; the leading result is (B, frames, ...):
    logits, encoder frames or argmax ids. Sizes are in encoder output
    frames. The B rows push the same number of samples together."""

    def __init__(self, encode_fn: Callable, encoder_params: dict, batch_size: int = 1,
                 chunk_frames: int = 16, history_frames: Optional[int] = None,
                 lookahead_frames: int = 2, device=None):
        self.encode_fn = encode_fn
        self.encoder_params = encoder_params
        self.batch_size = batch_size
        self.device = torch.device(device) if device is not None else default_device()
        self.geometry = geo = WindowGeometry(encoder_params, chunk_frames, history_frames,
                                             lookahead_frames)
        self.chunk_frames, self.history_frames = geo.chunk_frames, geo.history_frames
        self.lookahead_frames, self.window_frames = lookahead_frames, geo.window_frames
        self.window_samples, self.align = geo.window_samples, geo.align
        self._staged = np.zeros((batch_size, 0), np.float32)   # received, not uploaded
        self._received = 0       # samples pushed so far
        self._uploaded = 0       # absolute end of the device window
        self._buf = None         # (B, window_samples) rolling window on the device
        self.emitted = 0         # output frames emitted so far
        self.finished = False

    def _take_staged(self, n: int) -> np.ndarray:
        """Pop ``n`` staged samples, zero-padded past the end of the stream."""
        take = self._staged[:, :n]
        self._staged = self._staged[:, n:]
        if take.shape[1] < n:
            take = np.pad(take, ((0, 0), (0, n - take.shape[1])))
        return take

    def _upload(self, samples: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(samples)).to(self.device)

    def _advance_device_window(self, base: int):
        """Bring the device buffer to cover the window at ``base``."""
        target_end = self.geometry.need(base)
        if self._buf is None:
            self._buf = self._upload(self._take_staged(self.window_samples))
            self._uploaded = target_end
            return
        while self._uploaded < target_end:
            delta = min(self.geometry.chunk_samples, target_end - self._uploaded)
            new = self._upload(self._take_staged(delta))
            self._buf = torch.cat([self._buf[:, delta:], new], dim=1)
            self._uploaded += delta

    def push(self, samples) -> list[Emission]:
        """Feed (B, n) new samples; returns the windows they complete
        (possibly none, possibly several)."""
        if self.finished:
            raise RuntimeError("push after finish")
        samples = np.atleast_2d(np.asarray(samples, np.float32))
        if samples.shape[0] != self.batch_size:
            raise ValueError(f"{samples.shape[0]} rows pushed to a session of "
                             f"{self.batch_size}")
        self._staged = np.concatenate([self._staged, samples], axis=1)
        self._received += samples.shape[1]
        out = []
        while self.geometry.need(self.geometry.base(self.emitted)) <= self._received:
            out.append(self._run_window(self.geometry.base(self.emitted), None))
        return out

    def finish(self, x_len=None) -> list[Emission]:
        """End of stream: the remaining windows, zero-padded, with each row's
        real length ``x_len`` (all samples pushed by default), so that masks
        and lengths are those of the padded batch forward."""
        if self.finished:
            raise RuntimeError("finish twice")
        self.finished = True
        if x_len is None:
            x_len = np.full((self.batch_size,), self._received, np.int64)
        x_len = np.asarray(x_len, np.int64)
        total_out = encoder_output_frames(self.encoder_params, int(x_len.max()))
        out = []
        while self.emitted < total_out:
            out.append(self._run_window(self.geometry.base(self.emitted), x_len, total_out))
        return out

    def _run_window(self, base: int, x_len, total_out: Optional[int] = None) -> Emission:
        self._advance_device_window(base)
        s0 = base * self.geometry.samples_per_frame
        if x_len is None:
            w_len = np.full((self.batch_size,), self.window_samples, np.int64)
        else:
            w_len = np.clip(x_len - s0, 0, self.window_samples)
        with torch.inference_mode():
            res = self.encode_fn(self._buf, self._upload(w_len))
        frames = res[0] if isinstance(res, (tuple, list)) else res
        last = self.geometry.emit_end(base, total_out)
        em = Emission(frames=frames, first=self.emitted - base, last=last, start=self.emitted)
        self.emitted = base + last
        return em


# ---------------------------------------------------------------------------
# recognizers
# ---------------------------------------------------------------------------


def _frame_caps(encoder_params: dict, x_len) -> Optional[list[int]]:
    if x_len is None:
        return None
    return [encoder_output_frames(encoder_params, int(n))
            for n in np.atleast_1d(np.asarray(x_len))]


@dataclass
class StreamingCTC:
    """Greedy CTC over a session's windows, the collapse carried across
    them (model_ctc.py:90-136). Logits are reduced to argmax ids on the
    device and only the emitted ids are fetched; an ``encode_fn`` that
    returns ids (B, frames) works too."""

    session: StreamingEncoderSession
    _prev: np.ndarray = field(init=False, default=None)
    tokens: list = field(init=False, default=None)

    def __post_init__(self):
        b = self.session.batch_size
        self._prev = np.full((b,), -1, np.int64)
        self.tokens = [[] for _ in range(b)]

    def _consume(self, emissions, caps=None):
        for em in emissions:
            ids = em.frames
            if ids.dim() == 3:
                ids = ids.argmax(-1)
            preds = ids[:, em.first:em.last].cpu().numpy()
            for i in range(preds.shape[0]):
                cap = preds.shape[1] if caps is None else min(preds.shape[1],
                                                             caps[i] - em.start)
                for t in range(max(cap, 0)):
                    tok = int(preds[i, t])
                    if tok != 0 and tok != self._prev[i]:
                        self.tokens[i].append(tok)
                    self._prev[i] = tok

    def push(self, samples):
        self._consume(self.session.push(samples))
        return self.tokens

    def finish(self, x_len=None):
        self._consume(self.session.finish(x_len), _frame_caps(self.session.encoder_params,
                                                              x_len))
        return self.tokens


@dataclass
class StreamingTransducer:
    """Greedy Transducer decoding over a session's windows: the batched
    greedy loop (models/transducer.greedy_decode_stream) runs on each
    window's [first, last) frames, its state carried across windows."""

    model: object                 # models.transducer.Transducer
    session: StreamingEncoderSession
    max_tokens: int = 256
    max_consec_dec_steps: int = 5
    state: tuple = field(init=False, default=None)

    def _consume(self, emissions, caps=None):
        from efficientconformer_torch.models.transducer import greedy_decode_stream

        for em in emissions:
            b, dev = em.frames.shape[0], em.frames.device
            f_start = torch.full((b,), em.first, dtype=torch.long, device=dev)
            if caps is None:
                f_len = torch.full((b,), em.last, dtype=torch.long, device=dev)
            else:
                f_len = (torch.tensor(caps, device=dev) - (em.start - em.first)).clamp(
                    em.first, em.last)
            self.state = greedy_decode_stream(
                self.model, em.frames, f_len, self.state, f_start=f_start,
                max_tokens=self.max_tokens, max_consec_dec_steps=self.max_consec_dec_steps)

    def _tokens(self):
        """(tokens (B, max_tokens), counts (B,)) on the host."""
        if self.state is None:
            b = self.session.batch_size
            return np.zeros((b, 0), np.int64), np.zeros((b,), np.int64)
        return (self.state[3][:, :self.max_tokens].cpu().numpy(), self.state[4].cpu().numpy())

    def push(self, samples):
        self._consume(self.session.push(samples))
        return self._tokens()

    def finish(self, x_len=None):
        self._consume(self.session.finish(x_len), _frame_caps(self.session.encoder_params,
                                                              x_len))
        return self._tokens()
