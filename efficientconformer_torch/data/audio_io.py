"""Host-side audio decoding (replaces torchaudio.load, reference
utils/datasets.py:45).

Counterpart of efficientconformer_tpu/data/audio_io.py, with the same
results. WAV (PCM16, PCM32, float32, 8-bit) is decoded with numpy. FLAC,
LibriSpeech's format, is decoded by the repository's C++ decoder
(native/flac_decode.cpp through data/native.py), or by the ``flac`` or
``ffmpeg`` command where that library cannot be built. ``flac_backend``
says which one decodes. The native call releases the interpreter lock, so
the loader's thread pool decodes in parallel. Decoded audio is float32 in
[-1, 1], shape (T,), with its sample rate.
"""

from __future__ import annotations

import functools
import io
import shutil
import subprocess
import wave
from typing import Optional, Tuple

import numpy as np

from efficientconformer_torch.data import native


def load_flac_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode a FLAC byte stream with the native decoder -> (float32 mono, sr)."""
    samples, sr, ch, bps = native.flac_decode(data)
    x = samples.astype(np.float32) / float(1 << (bps - 1))
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr


@functools.lru_cache(maxsize=1)
def flac_backend() -> Optional[str]:
    """What decodes FLAC in this process: "native", "flac", "ffmpeg", or
    None when nothing can."""
    try:
        native.load()
        return "native"
    except native.NativeUnavailable:
        pass
    for tool in ("flac", "ffmpeg"):
        if shutil.which(tool):
            return tool
    return None


def load_wav_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    with wave.open(io.BytesIO(data), "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        raw = w.readframes(n)
        ch = w.getnchannels()
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr


def load_audio(path: str) -> Tuple[np.ndarray, int]:
    """Decode an audio file to (float32 mono (T,), sample_rate)."""
    if path.endswith(".wav"):
        with open(path, "rb") as f:
            return load_wav_bytes(f.read())
    if path.endswith(".flac"):
        backend = flac_backend()
        if backend is None:
            raise RuntimeError("No FLAC decoder available (native build failed and no "
                               "`flac`/`ffmpeg` on PATH).")
        if backend == "native":
            with open(path, "rb") as f:
                return load_flac_bytes(f.read())
        if backend == "flac":
            cmd = ["flac", "-dcs", "--force-raw-format", "--endian=little", "--sign=signed",
                   path]
        else:
            cmd = ["ffmpeg", "-v", "quiet", "-i", path, "-f", "s16le", "-ac", "1", "-"]
        out = subprocess.run(cmd, capture_output=True, check=True).stdout
        return np.frombuffer(out, np.int16).astype(np.float32) / 32768.0, 16000
    raise ValueError(f"unsupported audio format: {path}")


def audio_length(path: str) -> int:
    """Number of samples without decoding the payload (WAV header, FLAC
    STREAMINFO)."""
    if path.endswith(".wav"):
        with wave.open(path, "rb") as w:
            return w.getnframes()
    if path.endswith(".flac"):
        with open(path, "rb") as f:
            if f.read(4) != b"fLaC":
                raise ValueError(f"not a flac file: {path}")
            f.read(4)             # the first metadata block's header: STREAMINFO's
            f.read(10)            # min/max block and frame sizes
            return int.from_bytes(f.read(8), "big") & ((1 << 36) - 1)
    raise ValueError(f"unsupported audio format: {path}")
