"""Continuous-batching streaming ASR server (a pool of slots).

Counterpart of efficientconformer_tpu/serving.py. ``StreamingEncoderSession``
(streaming.py) runs B streams in lockstep; a server runs a fixed pool of
``num_slots`` rows behind one window step, with admission, advance and
retirement per slot:

* Fixed shapes: each window step runs over the whole pool; idle rows carry
  zeros and their outputs are dropped on the host.
* The per-row window advance is one gather: each slot's rolling window
  shifts by its own amount (0 for a row that does not advance, up to one
  chunk), ``gather(cat([buf, new]), shift + arange(W))`` on the device.
* Host and device exchange per step the new samples (num_slots x
  chunk_samples) and three (num_slots,) vectors; the rolling windows and,
  for the Transducer, the decode state stay on the device. The first
  windows of the slots admitted in a tick are placed in one indexed write.
* The window geometry and emission bookkeeping are the session's, so a
  stream served here gives the tokens the single-stream runtime gives it
  alone.

Decoders: ``CTCGreedyDecoder`` (the default; argmax on the device, the
collapse on the host, model_ctc.py:90-136) and ``TransducerGreedyDecoder``
(models/transducer.greedy_decode_stream with per-row frame ranges, the
decode state a device row per slot, reset from a template on reuse).

Eager PyTorch, and the host waits for the card at these points of a tick
(torch's sync debug mode counts them, chip_smoke.py's [serve-rate]): each
upload from pageable host memory, three a window step (the new samples, the
shifts, the lengths) and two at an admission (the rows and their first
windows); the CTC decoder's one read of all the tick's argmax ids at the
end; the Transducer's greedy loop, one flag an iteration, and its token
read at the end. The server runs on the card unless the caller names
another device, and raises without one.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from efficientconformer_torch.config import default_device, encoder_output_frames
from efficientconformer_torch.streaming import WindowGeometry

IDLE, ACTIVE, DRAINING = 0, 1, 2


@dataclass
class _Slot:
    state: int = IDLE
    stream_id: Optional[str] = None
    staged: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    received: int = 0        # samples pushed by the client so far
    uploaded: int = 0        # absolute end of this row's device window
    emitted: int = 0         # encoder output frames emitted so far
    placed: bool = False     # first window uploaded
    x_len: Optional[int] = None       # set at end(): the stream's length
    total_out: Optional[int] = None


@dataclass
class TickResult:
    """One tick: the NEW tokens of each stream, the finished streams with
    their whole token sequence, and the window steps run."""

    emitted: Dict[str, List[int]] = field(default_factory=dict)
    finished: Dict[str, List[int]] = field(default_factory=dict)
    windows_run: int = 0


# ---------------------------------------------------------------------------
# decoders
# ---------------------------------------------------------------------------


class CTCGreedyDecoder:
    """Greedy CTC over the server's window steps: the argmax on the device,
    the collapse on the host with a carry per slot. ``consume`` only keeps
    the step's ids on the device; ``collect`` fetches all of a tick's steps
    in one read and collapses them in order."""

    def bind(self, server: "StreamingServer"):
        self._prev = [-1] * server.num_slots
        self._toks: List[List[int]] = [[] for _ in range(server.num_slots)]
        self._pending: List[tuple] = []

    @staticmethod
    def device_post(frames):
        return frames.argmax(-1) if frames.dim() == 3 else frames

    def consume(self, step_out, metas):
        self._pending.append((step_out, metas))

    def collect(self) -> Dict[int, List[int]]:
        news: Dict[int, List[int]] = {}
        if not self._pending:
            return news
        # the decoder's one read a tick
        ids = torch.stack([s for s, _ in self._pending]).cpu().numpy()
        for step, (_, metas) in enumerate(self._pending):
            for i, first, last in metas:
                fresh = news.setdefault(i, [])
                for t in range(first, last):
                    tok = int(ids[step, i, t])
                    if tok != 0 and tok != self._prev[i]:
                        fresh.append(tok)
                        self._toks[i].append(tok)
                    self._prev[i] = tok
        self._pending = []
        return {i: v for i, v in news.items() if v}

    def finalize(self, i: int) -> List[int]:
        return self._toks[i]

    def reset_many(self, idxs: List[int]):
        for i in idxs:
            self._prev[i] = -1
            self._toks[i] = []


class TransducerGreedyDecoder:
    """Greedy Transducer decoding over the server's window steps: the
    batched greedy loop runs per step with per-row frame ranges; rows that
    do not advance get f_start = f_len = 0 and are left as they are. The
    decode state of every slot is a device row; admission resets the
    admitted rows from the initial state, one ``torch.where`` per leaf."""

    def __init__(self, model, max_tokens: int = 256, max_consec_dec_steps: int = 5):
        self.model = model
        self.max_tokens = max_tokens
        self.max_consec = max_consec_dec_steps

    def bind(self, server: "StreamingServer"):
        from efficientconformer_torch.models.transducer import init_state

        with torch.inference_mode():
            self._template = init_state(self.model, server.num_slots, self.max_tokens,
                                        server.device)
        self._state = self._template
        self._n_prev = [0] * server.num_slots
        self._host = None       # (n_tok, tokens) as of the last collect()
        self._dirty = False     # a window step launched since the last collect()?
        self._device = server.device

    @staticmethod
    def device_post(frames):
        return frames

    def consume(self, step_out, metas):
        """Queue the decode of this step's frames; the state chains on the
        previous step's on the device."""
        from efficientconformer_torch.models.transducer import greedy_decode_stream

        b = step_out.shape[0]
        f_start = np.zeros(b, np.int64)
        f_len = np.zeros(b, np.int64)
        for i, first, last in metas:
            f_start[i], f_len[i] = first, last
        self._state = greedy_decode_stream(
            self.model, step_out, torch.from_numpy(f_len).to(self._device), self._state,
            f_start=torch.from_numpy(f_start).to(self._device), max_tokens=self.max_tokens,
            max_consec_dec_steps=self.max_consec)
        self._dirty = True

    def collect(self) -> Dict[int, List[int]]:
        if not self._dirty:
            return {}         # no step since the last read: nothing new
        self._dirty = False
        n_tok = self._state[4].cpu().numpy().copy()       # copies: reset zeroes rows
        tokens = self._state[3].cpu().numpy()
        self._host = (n_tok, tokens)
        news: Dict[int, List[int]] = {}
        for i in range(n_tok.shape[0]):
            n = int(n_tok[i])
            if n > self._n_prev[i]:
                news[i] = [int(t) for t in tokens[i, self._n_prev[i]:n]]
                self._n_prev[i] = n
        return news

    def finalize(self, i: int) -> List[int]:
        if self._host is None:
            self._host = (self._state[4].cpu().numpy().copy(), self._state[3].cpu().numpy())
        n_tok, tokens = self._host
        return [int(t) for t in tokens[i, :int(n_tok[i])]]

    def reset_many(self, idxs: List[int]):
        from efficientconformer_torch.models.transducer import reset_state_rows

        rows = np.zeros(len(self._n_prev), bool)
        rows[idxs] = True
        self._state = reset_state_rows(self._state, self._template,
                                       torch.from_numpy(rows).to(self._device))
        for i in idxs:
            self._n_prev[i] = 0
            if self._host is not None:
                self._host[0][i] = 0


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


class StreamingServer:
    """Slot-pool continuous batching over a streaming encoder.

    ``encode_fn(audio (B, T), x_len (B,)) -> logits | frames | (..., ...)``,
    the session's contract: logits for the CTC decoder, encoder frames for
    the Transducer's. Typical loop::

        srv = StreamingServer(encode_fn, encoder_params, num_slots=16)
        srv.submit("a"); srv.push("a", samples); ...
        events = srv.tick()         # at the chunk cadence
        srv.end("a")                # the client hangs up; drained by later ticks

    ``max_windows_per_tick`` bounds the window steps of one tick; slots with
    a deeper backlog keep the rest for later ticks (the same windows in
    all). None runs every complete window in the tick.
    """

    def __init__(self, encode_fn: Callable, encoder_params: dict, num_slots: int = 16,
                 chunk_frames: int = 16, history_frames: Optional[int] = None,
                 lookahead_frames: int = 2, decoder=None,
                 max_windows_per_tick: Optional[int] = None, device=None):
        self.params = encoder_params
        self.num_slots = num_slots
        self.device = torch.device(device) if device is not None else default_device()
        self.geometry = geo = WindowGeometry(encoder_params, chunk_frames, history_frames,
                                             lookahead_frames)
        self.history_frames, self.chunk_frames = geo.history_frames, geo.chunk_frames
        self.lookahead_frames, self.window_frames = lookahead_frames, geo.window_frames
        self.window_samples, self.chunk_samples = geo.window_samples, geo.chunk_samples
        self.max_windows_per_tick = max_windows_per_tick
        self._encode_fn = encode_fn

        self._slots = [_Slot() for _ in range(num_slots)]
        self._by_id: Dict[str, int] = {}       # stream_id -> slot index
        self._queue: List[str] = []            # submitted, waiting for a slot
        self._pending: Dict[str, _Slot] = {}   # queued streams buffer here
        self._results: Dict[str, List[int]] = {}

        self._buf = torch.zeros((num_slots, self.window_samples), device=self.device)
        self._window = torch.arange(self.window_samples, device=self.device)[None, :]
        self._decoder = decoder if decoder is not None else CTCGreedyDecoder()
        self._decoder.bind(self)

    # ------------------------------------------------------------- client API

    def submit(self, stream_id: str):
        """Register a new stream; it takes a slot at the next tick with a
        free one, in the order submitted."""
        if stream_id in self._by_id or stream_id in self._pending:
            raise ValueError(f"duplicate stream id {stream_id!r}")
        self._pending[stream_id] = _Slot(state=ACTIVE, stream_id=stream_id)
        self._queue.append(stream_id)

    def push(self, stream_id: str, samples):
        """Append audio samples (1-D float32) to a stream."""
        slot = self._slot_of(stream_id)
        if slot.x_len is not None:
            raise ValueError(f"stream {stream_id!r} already ended")
        samples = np.asarray(samples, np.float32).reshape(-1)
        slot.staged = np.concatenate([slot.staged, samples])
        slot.received += samples.size

    def end(self, stream_id: str, x_len: Optional[int] = None):
        """Mark the end of a stream: its remaining windows (zero-padded,
        with the real length, as the session's ``finish``) drain over the
        next ticks."""
        slot = self._slot_of(stream_id)
        slot.x_len = int(slot.received if x_len is None else x_len)
        slot.total_out = int(encoder_output_frames(self.params, slot.x_len))
        slot.state = DRAINING

    def result(self, stream_id: str) -> Optional[List[int]]:
        return self._results.get(stream_id)

    @property
    def active_streams(self) -> int:
        return sum(s.state != IDLE for s in self._slots)

    @property
    def queued_streams(self) -> int:
        return len(self._queue)

    # ---------------------------------------------------------------- serving

    def _slot_of(self, stream_id: str) -> _Slot:
        if stream_id in self._by_id:
            return self._slots[self._by_id[stream_id]]
        if stream_id in self._pending:
            return self._pending[stream_id]
        raise KeyError(f"unknown stream {stream_id!r}")

    def _admit(self):
        admitted = []
        for i, s in enumerate(self._slots):
            if not self._queue:
                break
            if s.state == IDLE:
                sid = self._queue.pop(0)
                self._slots[i] = self._pending.pop(sid)
                self._by_id[sid] = i
                admitted.append(i)
        if admitted:
            self._decoder.reset_many(admitted)

    def _runnable(self, slot: _Slot) -> bool:
        if slot.state == ACTIVE:
            return slot.received >= self.geometry.need(self.geometry.base(slot.emitted))
        if slot.state == DRAINING:
            return slot.emitted < slot.total_out
        return False

    @staticmethod
    def _take_staged(slot: _Slot, n: int) -> np.ndarray:
        take = slot.staged[:n]
        slot.staged = slot.staged[n:]
        if take.size < n:
            take = np.pad(take, (0, n - take.size))
        return take

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        # from pageable memory: the host waits for the card's queue
        return torch.from_numpy(a).to(self.device)

    def _finish_slot(self, i: int, out: TickResult):
        s = self._slots[i]
        toks = self._decoder.finalize(i)
        self._results[s.stream_id] = toks
        out.finished[s.stream_id] = toks
        del self._by_id[s.stream_id]
        self._slots[i] = _Slot()

    def _step(self, new, shift, w_len):
        """One window step over the pool: each row's window advances by its
        shift (a gather), then the encoder and the decoder's device part."""
        ext = torch.cat([self._buf, new], dim=1)
        self._buf = torch.gather(ext, 1, self._window + shift[:, None])
        res = self._encode_fn(self._buf, w_len)
        frames = res[0] if isinstance(res, (tuple, list)) else res
        return type(self._decoder).device_post(frames)

    @torch.inference_mode()
    def tick(self) -> TickResult:
        """Admit queued streams, then run window steps over the pool until
        no slot has a complete window (or ``max_windows_per_tick`` steps
        ran). Returns the tokens emitted and the streams finished."""
        geo = self.geometry
        self._admit()
        out = TickResult()
        finish_order: List[int] = []

        # streams of zero frames finish at once
        for i, s in enumerate(self._slots):
            if s.state == DRAINING and s.total_out == 0:
                self._finish_slot(i, out)
        self._admit()

        # the first windows of fresh slots, placed in one indexed write
        fresh_idx: List[int] = []
        fresh_rows: List[np.ndarray] = []
        for i, s in enumerate(self._slots):
            if s.state != IDLE and not s.placed and self._runnable(s):
                fresh_idx.append(i)
                fresh_rows.append(self._take_staged(s, self.window_samples))
                s.uploaded = self.window_samples
                s.placed = True
        if fresh_idx:
            self._buf[self._upload(np.asarray(fresh_idx))] = self._upload(np.stack(fresh_rows))

        while (self.max_windows_per_tick is None
               or out.windows_run < self.max_windows_per_tick):
            run = [s.state != IDLE and s.placed and self._runnable(s) for s in self._slots]
            if not any(run):
                break
            shift = np.zeros(self.num_slots, np.int64)
            new = np.zeros((self.num_slots, self.chunk_samples), np.float32)
            w_len = np.full(self.num_slots, self.window_samples, np.int64)
            meta = {}
            for i, s in enumerate(self._slots):
                if not run[i]:
                    continue
                base = geo.base(s.emitted)
                need = geo.need(base)
                delta = need - s.uploaded
                assert 0 <= delta <= self.chunk_samples, (delta, base)
                if delta:
                    # the window is ext[shift : shift + W], whose tail reads
                    # new[:delta]: fill the row from the left
                    new[i, :delta] = self._take_staged(s, delta)
                    shift[i] = delta
                    s.uploaded = need
                if s.state == DRAINING:
                    w_len[i] = np.clip(s.x_len - base * geo.samples_per_frame, 0,
                                       self.window_samples)
                last = geo.emit_end(base, s.total_out if s.state == DRAINING else None)
                meta[i] = (s.emitted - base, last, base)
            step_out = self._step(self._upload(new), self._upload(shift), self._upload(w_len))
            out.windows_run += 1
            self._decoder.consume(step_out, [(i, f, l) for i, (f, l, _) in meta.items()])
            for i, (_, last, base) in meta.items():
                s = self._slots[i]
                s.emitted = base + last
                if s.state == DRAINING and s.emitted >= s.total_out and i not in finish_order:
                    finish_order.append(i)

        for i, news in self._decoder.collect().items():
            s = self._slots[i]
            if s.stream_id is not None and news:
                out.emitted.setdefault(s.stream_id, []).extend(news)
        for i in finish_order:
            self._finish_slot(i, out)
        return out

    def drain(self, max_ticks: int = 10_000) -> Dict[str, List[int]]:
        """Tick until every submitted stream has finished (each must have
        been ended). Returns all results."""
        for _ in range(max_ticks):
            self.tick()
            if not self._by_id and not self._queue:
                return dict(self._results)
        raise RuntimeError("drain did not converge (a stream not ended?)")
