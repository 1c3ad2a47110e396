"""Minimal sentencepiece ``ModelProto`` reader/writer (no protobuf dep).

A copy of efficientconformer_tpu/data/spm_model.py, kept here so that the
port imports nothing of the JAX package.

The reference pairs its published checkpoints with a sentencepiece BPE
``.model`` file (reference utils/preprocessing.py:84 trains it, reference
models/model.py:50 loads it, and the demo notebook downloads
``librispeech_bpe_256.model``). Reproducing the published WER numbers
therefore requires reading that exact vocabulary. This module parses the
protobuf *wire format* of sentencepiece's ``ModelProto`` directly — only the
fields the BPE runtime needs:

    ModelProto:
      repeated SentencePiece pieces = 1;
        SentencePiece { string piece = 1; float score = 2; Type type = 3; }
      TrainerSpec   trainer_spec   = 2;   (model_type read, rest skipped)
      NormalizerSpec normalizer_spec = 3; (skipped — identity for the
                                           reference's A-Z' corpus)

A serializer is provided so (a) round-trip tests can validate the parser
without the sentencepiece package (absent from this image) and (b) our own
trained tokenizers can be exported as ``.model`` files the reference
implementation can load.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

# SentencePiece.Type enum values (sentencepiece_model.proto)
NORMAL = 1
UNKNOWN = 2
CONTROL = 3
USER_DEFINED = 4
UNUSED = 5
BYTE = 6

# TrainerSpec.ModelType enum values
MODEL_TYPE_UNIGRAM = 1
MODEL_TYPE_BPE = 2
MODEL_TYPE_WORD = 3
MODEL_TYPE_CHAR = 4


@dataclass
class SpmModel:
    pieces: List[str] = field(default_factory=list)
    scores: List[float] = field(default_factory=list)
    types: List[int] = field(default_factory=list)
    model_type: Optional[int] = None  # TrainerSpec.model_type if present


# --------------------------------------------------------------------------
# wire-format primitives
# --------------------------------------------------------------------------

def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _skip_field(data: bytes, pos: int, wire: int) -> int:
    if wire == 0:  # varint
        _, pos = _read_varint(data, pos)
    elif wire == 1:  # 64-bit
        pos += 8
    elif wire == 2:  # length-delimited
        n, pos = _read_varint(data, pos)
        pos += n
    elif wire == 5:  # 32-bit
        pos += 4
    elif wire == 3:  # group start: skip until matching end
        while True:
            tag, pos = _read_varint(data, pos)
            w = tag & 7
            if w == 4:
                break
            pos = _skip_field(data, pos, w)
    else:
        raise ValueError(f"unsupported wire type {wire}")
    if pos > len(data):
        raise ValueError("truncated field")
    return pos


def _fields(data: bytes):
    """Yield (field_number, wire_type, value) over a message's fields.

    value is: int for varint, bytes for length-delimited, raw 4/8 bytes for
    fixed-width. Groups are skipped.
    """
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        fnum, wire = tag >> 3, tag & 7
        if wire == 0:
            v, pos = _read_varint(data, pos)
            yield fnum, wire, v
        elif wire == 2:
            n, pos = _read_varint(data, pos)
            if pos + n > len(data):
                raise ValueError("truncated length-delimited field")
            yield fnum, wire, data[pos:pos + n]
            pos += n
        elif wire == 5:
            yield fnum, wire, data[pos:pos + 4]
            pos += 4
        elif wire == 1:
            yield fnum, wire, data[pos:pos + 8]
            pos += 8
        else:
            pos = _skip_field(data, pos, wire)


# --------------------------------------------------------------------------
# ModelProto
# --------------------------------------------------------------------------

def parse_model_proto(data: bytes) -> SpmModel:
    """Parse a serialized sentencepiece ModelProto into pieces/scores/types."""
    model = SpmModel()
    for fnum, wire, value in _fields(data):
        if fnum == 1 and wire == 2:  # SentencePiece
            piece, score, ptype = "", 0.0, NORMAL
            for sf, sw, sv in _fields(value):
                if sf == 1 and sw == 2:
                    piece = sv.decode("utf-8")
                elif sf == 2 and sw == 5:
                    score = struct.unpack("<f", sv)[0]
                elif sf == 3 and sw == 0:
                    ptype = int(sv)
            model.pieces.append(piece)
            model.scores.append(score)
            model.types.append(ptype)
        elif fnum == 2 and wire == 2:  # TrainerSpec
            for sf, sw, sv in _fields(value):
                if sf == 3 and sw == 0:  # model_type
                    model.model_type = int(sv)
    if not model.pieces:
        raise ValueError("no sentence pieces found (not a ModelProto?)")
    return model


def serialize_model_proto(pieces: List[str], scores: List[float],
                          types: Optional[List[int]] = None,
                          model_type: int = MODEL_TYPE_BPE) -> bytes:
    """Serialize pieces/scores/types as a sentencepiece ModelProto."""
    if types is None:
        types = [UNKNOWN if i == 0 else NORMAL for i in range(len(pieces))]
    assert len(pieces) == len(scores) == len(types)
    out = bytearray()
    for piece, score, ptype in zip(pieces, scores, types):
        sp = bytearray()
        pb = piece.encode("utf-8")
        sp.append(0x0A)  # field 1, wire 2
        _write_varint(sp, len(pb))
        sp += pb
        sp.append(0x15)  # field 2, wire 5
        sp += struct.pack("<f", float(score))
        if ptype != NORMAL:  # proto3-style: NORMAL is sentencepiece's default
            sp.append(0x18)  # field 3, wire 0
            _write_varint(sp, ptype)
        out.append(0x0A)  # ModelProto field 1, wire 2
        _write_varint(out, len(sp))
        out += sp
    # TrainerSpec with model_type only
    ts = bytearray()
    ts.append(0x18)  # field 3, wire 0
    _write_varint(ts, model_type)
    out.append(0x12)  # ModelProto field 2, wire 2
    _write_varint(out, len(ts))
    out += ts
    return bytes(out)


def looks_like_model_proto(head: bytes) -> bool:
    """Cheap format sniff: a ModelProto starts with field-1 length-delimited
    (0x0A); a JSON tokenizer file starts with '{'."""
    return bool(head) and head[0] == 0x0A
