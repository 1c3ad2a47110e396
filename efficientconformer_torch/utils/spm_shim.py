"""Drop-in ``sentencepiece`` module shim backed by the port's BPE runtime.

The port's own copy of the part of efficientconformer_tpu/utils/spm_shim.py
that reading the original repo's checkpoints needs, over
efficientconformer_torch/data/tokenizer.py. No sentencepiece package is
needed.

The original repo's checkpoints pickle a
``sentencepiece.SentencePieceProcessor`` inside the ``.ckpt`` dict
(reference models/model.py:355 saves ``"tokenizer": self.tokenizer``). The
real wrapper pickles via ``__getstate__ -> serialized_model_proto()``
bytes, so unpickling only needs a class at
``sentencepiece.SentencePieceProcessor`` whose ``__setstate__`` accepts
those bytes: this shim parses them with data/spm_model.py
(import_checkpoint.py). With ``install()`` in ``sys.modules``,
``sentencepiece.SentencePieceProcessor(path)`` also loads a ``.model``
file, and pickles as the real class does.

The surface: the constructor, ``Load``, ``LoadFromSerializedProto``,
``serialized_model_proto``, pickling, ``encode`` (int ids), ``decode`` and
``vocab_size``.
"""

from __future__ import annotations

import sys
import types

from efficientconformer_torch.data.tokenizer import BpeTokenizer


class SentencePieceProcessor:
    def __init__(self, model_file=None):
        # The original calls spm.SentencePieceProcessor(path) positionally
        # (models/model.py:50); the real API also accepts model_file=...
        self._tok = None
        self._proto = None
        if model_file is not None:
            self.Load(model_file)

    def Load(self, path):
        self._tok = BpeTokenizer.load(path)
        self._proto = getattr(self._tok, "_proto_bytes", None)
        if self._proto is None:
            self._proto = self._tok.to_sentencepiece_bytes()
        return True

    load = Load

    def LoadFromSerializedProto(self, data):
        self._tok = BpeTokenizer.from_sentencepiece(bytes(data))
        self._proto = bytes(data)
        return True

    def serialized_model_proto(self):
        if self._proto is None:
            raise RuntimeError("no model loaded")
        return self._proto

    # pickling, as the real wrapper pickles: the ModelProto bytes
    def __getstate__(self):
        return self.serialized_model_proto()

    def __setstate__(self, state):
        self.LoadFromSerializedProto(state)

    @property
    def tokenizer(self) -> BpeTokenizer:
        if self._tok is None:
            raise RuntimeError("no model loaded")
        return self._tok

    def encode(self, text):
        return self.tokenizer.encode(text)

    def decode(self, ids):
        return self.tokenizer.decode(ids)

    def vocab_size(self):
        return self.tokenizer.vocab_size()


def install() -> types.ModuleType:
    """Install this shim as ``sys.modules['sentencepiece']`` (no-op if a real
    sentencepiece is already importable)."""
    existing = sys.modules.get("sentencepiece")
    if existing is not None:
        return existing  # the shim already, or a real sentencepiece, which wins
    try:
        import sentencepiece  # noqa: F401

        return sys.modules["sentencepiece"]
    except ImportError:
        pass
    mod = types.ModuleType("sentencepiece")
    mod.SentencePieceProcessor = SentencePieceProcessor
    # Pickles of shim processors must name the class as
    # "sentencepiece.SentencePieceProcessor" (what the original's checkpoints
    # contain, and what a host with the real package can unpickle).
    SentencePieceProcessor.__module__ = "sentencepiece"
    mod.__shim__ = True
    sys.modules["sentencepiece"] = mod
    return mod
