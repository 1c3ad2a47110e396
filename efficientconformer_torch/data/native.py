"""ctypes binding to the repository's C++ host code (``native/*.cpp``).

The port's own counterpart of the JAX package's bindings
(decoding/native_binding.py, data/audio_io.py, data/tokenizer_native.py):
the four sources that native/Makefile lists are compiled with that
Makefile's flags by ``g++`` at first use into
``build/native/libecf_native-<hash>.so`` at the repository root (listed in
``.gitignore``), the hash being that of the sources, so an edited source is
rebuilt and a stale library never loaded. The sources are shared with the
JAX package and not edited here. Bound: the FLAC decoder
(``flac_decode.cpp``), the BPE encoder (``bpe_encode.cpp``), the BPE
trainer (``bpe_train.cpp``) and the CTC prefix beam search with its ARPA
scorer (``ctc_beam.cpp``, the host beam of decoding/ctc_beam.py). Nothing is
compiled or loaded when this module is imported. ``load`` raises
``NativeUnavailable`` when there is no compiler or the build fails; the
data path has its own fallback, the host CTC beam has none.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

SRC_DIR = Path(__file__).resolve().parents[2] / "native"
SOURCES = ("ctc_beam.cpp", "bpe_encode.cpp", "flac_decode.cpp", "bpe_train.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_lib: dict = {}


class NativeUnavailable(RuntimeError):
    """The native library cannot be built or loaded where the code runs."""


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libecf_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless their library exists; its path."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise NativeUnavailable("no C++ compiler (g++) to build native/*.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *(str(SRC_DIR / s) for s in SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise NativeUnavailable(f"g++ failed on native/*.cpp:\n{res.stderr}")
    os.replace(tmp, out)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    c_int_p = ctypes.POINTER(ctypes.c_int)
    lib.ecf_flac_info.restype = ctypes.c_int
    lib.ecf_flac_info.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_longlong), c_int_p,
        c_int_p, c_int_p]
    lib.ecf_flac_decode.restype = ctypes.c_longlong
    lib.ecf_flac_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int32), ctypes.c_longlong]
    lib.ecf_bpe_create.restype = ctypes.c_void_p
    lib.ecf_bpe_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int]
    lib.ecf_bpe_free.restype = None
    lib.ecf_bpe_free.argtypes = [ctypes.c_void_p]
    lib.ecf_bpe_encode.restype = ctypes.c_int
    lib.ecf_bpe_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, c_int_p, ctypes.c_int]
    lib.ecf_bpe_train.restype = ctypes.c_void_p
    lib.ecf_bpe_train.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.ecf_bpe_result_size.restype = ctypes.c_longlong
    lib.ecf_bpe_result_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ecf_bpe_result.restype = None
    lib.ecf_bpe_result.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p]
    lib.ecf_bpe_train_free.restype = None
    lib.ecf_bpe_train_free.argtypes = [ctypes.c_void_p]
    lib.ecf_arpa_load.restype = ctypes.c_void_p
    lib.ecf_arpa_load.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.ecf_arpa_free.restype = None
    lib.ecf_arpa_free.argtypes = [ctypes.c_void_p]
    lib.ecf_ctc_beam_search.restype = ctypes.c_int
    lib.ecf_ctc_beam_search.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_double, ctypes.c_double, ctypes.c_int, c_int_p,
        ctypes.c_int]


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed (once per process, also
    when the loader's decode threads ask together)."""
    with _lock:
        if "lib" not in _lib:
            try:
                lib = ctypes.CDLL(str(build()))
            except OSError as e:
                raise NativeUnavailable(str(e)) from e
            _declare(lib)
            _lib["lib"] = lib
        return _lib["lib"]


def flac_decode(data: bytes) -> Tuple[np.ndarray, int, int, int]:
    """Decode a FLAC byte stream: (interleaved int32 samples (T * channels,),
    sample rate, channels, bits per sample). Raises ValueError on a stream
    the decoder rejects. The call releases the interpreter lock."""
    lib = load()
    total, sr, ch, bps = ctypes.c_longlong(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.ecf_flac_info(data, len(data), ctypes.byref(total), ctypes.byref(sr),
                         ctypes.byref(ch), ctypes.byref(bps)) != 0:
        raise ValueError("invalid FLAC stream")
    cap = total.value if total.value else len(data) * 4 + 65536
    out = np.empty((cap * ch.value,), np.int32)
    n = lib.ecf_flac_decode(data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                            cap)
    if n < 0:
        raise ValueError("FLAC decode failed")
    return out[: n * ch.value], sr.value, ch.value, bps.value


def bpe_train(corpus_path: str, vocab_size: int, lowercase: bool) -> Tuple[List[str], List[tuple]]:
    """Train BPE on a text file with the C++ trainer: (pieces without
    <unk>, merges). Raises FileNotFoundError if the corpus cannot be read."""
    lib = load()
    h = lib.ecf_bpe_train(corpus_path.encode(), vocab_size, int(lowercase))
    if not h:
        raise FileNotFoundError(corpus_path)
    try:
        def blob(which):
            buf = ctypes.create_string_buffer(int(lib.ecf_bpe_result_size(h, which)))
            lib.ecf_bpe_result(h, which, buf)
            return buf.raw.decode()

        pieces = [p for p in blob(0).split("\n") if p]
        merges = [tuple(line.split("\t")) for line in blob(1).split("\n") if line]
    finally:
        lib.ecf_bpe_train_free(h)
    return pieces, merges


def _char_array(strings: Sequence[str]):
    arr = (ctypes.c_char_p * len(strings))()
    arr[:] = [s.encode("utf-8") for s in strings]
    return arr


class NativeBpe:
    """The C++ merge-list BPE encoder over ``pieces`` and ``merges``."""

    def __init__(self, pieces: List[str], merges: List[Tuple[str, str]]):
        self._lib = load()
        self._handle = self._lib.ecf_bpe_create(
            _char_array(pieces), len(pieces), _char_array([m[0] for m in merges]),
            _char_array([m[1] for m in merges]), len(merges))
        if not self._handle:
            raise NativeUnavailable("ecf_bpe_create failed")

    def encode(self, text: str) -> List[int]:
        data = text.encode("utf-8")
        out = (ctypes.c_int * max(len(data), 8))()      # at most one id per byte
        n = self._lib.ecf_bpe_encode(self._handle, data, out, len(out))
        return list(out[:n])

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.ecf_bpe_free(self._handle)
            self._handle = None


class NativeArpa:
    """An ARPA model loaded by the C++ scorer; FileNotFoundError when the
    file cannot be read."""

    def __init__(self, path: str, ngram_offset: int = 100):
        self._lib = load()
        self._handle = self._lib.ecf_arpa_load(path.encode(), ngram_offset)
        if not self._handle:
            raise FileNotFoundError(path)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.ecf_arpa_free(self._handle)
            self._handle = None


def ctc_beam_search(log_probs: np.ndarray, seq_len: int, beam_size: int = 16, blank: int = 0,
                    lm: "NativeArpa" = None, alpha: float = 0.0, beta: float = 0.0,
                    cutoff_top_n: int = 0) -> List[int]:
    """The C++ prefix beam search of one utterance's (T, V) natural-log
    probabilities; ``cutoff_top_n`` 0 scores the whole vocabulary. The call
    releases the interpreter lock."""
    lib = load()
    lp = np.ascontiguousarray(log_probs, np.float32)
    t, v = lp.shape
    out = np.zeros((t,), np.int32)
    n = lib.ecf_ctc_beam_search(
        lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), t, v, int(seq_len), beam_size, blank,
        lm._handle if lm is not None else None, alpha, beta, cutoff_top_n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), t)
    return out[:n].tolist()
