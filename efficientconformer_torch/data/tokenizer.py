"""BPE tokenizer with sentencepiece-compatible conventions.

Replaces the sentencepiece C++ dependency (reference utils/preprocessing.py:84,
models/model.py:50): id 0 is <unk> (shared with the CTC/RNN-T blank, decoded to
the empty string like the reference's unk_surface=""), bos/eos are disabled, and
word boundaries use the U+2581 marker with a dummy prefix on every word.

Training is standard BPE (greedy highest-frequency pair merging over the word
frequency table); encoding applies merges in rank order per word. The model is
persisted as a sentencepiece ``.model`` or as JSON at ``tokenizer_path``.

The counterpart of efficientconformer_tpu/data/tokenizer.py and
data/tokenizer_native.py, with the same file formats: a tokenizer that either
package saves loads in the other and encodes the same. Encoding and training
go through the C++ code of native/ (data/native.py) where it builds, through
the pure-Python versions otherwise; both give the same ids and merges.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Dict, Iterable, List, Tuple

from efficientconformer_torch.data import native, spm_model

WORD_BOUNDARY = "▁"  # ▁
UNK_ID = 0
UNK_PIECE = "<unk>"


class BpeTokenizer:
    def __init__(self, pieces: List[str], merges: List[Tuple[str, str]],
                 piece_scores: "List[float] | None" = None,
                 control_ids: "Iterable[int] | None" = None):
        self.pieces = pieces                       # index == id; pieces[0] == <unk>
        self.piece_to_id: Dict[str, int] = {p: i for i, p in enumerate(pieces)}
        self.merges = merges
        self.merge_rank: Dict[Tuple[str, str], int] = {
            tuple(m): i for i, m in enumerate(merges)
        }
        # sentencepiece mode: no explicit merge list — a pair (a, b) merges iff
        # a+b is in the vocab, with priority = score of the piece a+b (higher
        # score merges first; the SP BPE runtime's rule, bpe_model.cc).
        self.piece_scores = list(piece_scores) if piece_scores is not None else None
        # ids decoded to "" beyond <unk> (sentencepiece CONTROL/UNUSED pieces)
        self.control_ids = frozenset(control_ids or ())
        self._encode_cache: Dict[str, List[int]] = {}
        self._native = None
        self._native_tried = False

    def _native_encoder(self):
        """Lazily build the C++ encoder (native/bpe_encode.cpp); None if the
        native library is unavailable."""
        if not self._native_tried:
            self._native_tried = True
            if self.merges and self.piece_scores is None:
                try:
                    self._native = native.NativeBpe(self.pieces, self.merges)
                except native.NativeUnavailable:
                    self._native = None
        return self._native

    # ------------------------------------------------------------------ api

    def vocab_size(self) -> int:
        return len(self.pieces)

    def encode(self, text: str) -> List[int]:
        native = self._native_encoder()
        if native is not None:
            return native.encode(text)
        ids: List[int] = []
        for word in text.split():
            key = WORD_BOUNDARY + word
            cached = self._encode_cache.get(key)
            if cached is None:
                cached = self._encode_word(key)
                if len(self._encode_cache) < 1_000_000:
                    self._encode_cache[key] = cached
            ids.extend(cached)
        return ids

    def decode(self, ids) -> "str | list[str]":
        """Decode a list of ids, or a batch (list of lists) to strings."""
        if len(ids) and isinstance(ids[0], (list, tuple)):
            return [self.decode(seq) for seq in ids]
        text = "".join(
            self.pieces[i]
            if 0 < i < len(self.pieces) and i not in self.control_ids
            else ""
            for i in ids
        )
        return text.replace(WORD_BOUNDARY, " ").strip()

    # ------------------------------------------------------------ internals

    def _pair_priority(self, a: str, b: str):
        """Merge priority of the adjacent pair (a, b); smaller merges first;
        None if the pair cannot merge. Merge-list mode uses the merge rank;
        sentencepiece mode uses -score of the concatenated piece (matching the
        SP BPE runtime: any pair whose concatenation is in the vocab may
        merge, best score first, leftmost on ties)."""
        if self.piece_scores is not None:
            pid = self.piece_to_id.get(a + b)
            if pid is None:
                return None
            return -self.piece_scores[pid]
        return self.merge_rank.get((a, b))

    def _encode_word(self, word: str) -> List[int]:
        symbols = list(word)
        while len(symbols) > 1:
            best_rank, best_i = None, -1
            for i in range(len(symbols) - 1):
                r = self._pair_priority(symbols[i], symbols[i + 1])
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            symbols[best_i : best_i + 2] = [symbols[best_i] + symbols[best_i + 1]]
        return [self.piece_to_id.get(s, UNK_ID) for s in symbols]

    # ---------------------------------------------------------- persistence

    def save(self, path: str) -> None:
        """Persist the tokenizer. A ``.model`` path gets a real sentencepiece
        ModelProto (loadable by the reference implementation and by the real
        sentencepiece package, reference models/model.py:50); any other path
        gets this framework's JSON format. ``load`` auto-detects both."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if path.endswith(".model"):
            with open(path, "wb") as f:
                f.write(getattr(self, "_proto_bytes", None)
                        or self.to_sentencepiece_bytes())
            return
        if self.piece_scores is not None:
            raise ValueError(
                "a sentencepiece-mode tokenizer has no merge list; save it "
                "to a .model path instead")
        with open(path, "w") as f:
            json.dump({"pieces": self.pieces, "merges": self.merges}, f)

    @classmethod
    def load(cls, path: str) -> "BpeTokenizer":
        """Load a tokenizer file — either this framework's JSON format or a
        sentencepiece ``.model`` protobuf (the reference's published artifact,
        reference models/model.py:50), auto-detected by content."""
        with open(path, "rb") as f:
            data = f.read()
        if spm_model.looks_like_model_proto(data):
            return cls.from_sentencepiece(data)
        d = json.loads(data.decode("utf-8"))
        return cls(d["pieces"], [tuple(m) for m in d["merges"]])

    @classmethod
    def from_sentencepiece(cls, source) -> "BpeTokenizer":
        """Build from a sentencepiece BPE ``.model`` file (path or serialized
        ModelProto bytes). Encoding follows the SP BPE runtime exactly:
        greedy best-score adjacent merges over vocab membership. The
        reference trains with bos/eos disabled and unk_surface="" (reference
        utils/preprocessing.py:84); CONTROL pieces, if present, decode to ""."""
        if isinstance(source, (bytes, bytearray)):
            data = bytes(source)
        else:
            with open(source, "rb") as f:
                data = f.read()
        model = spm_model.parse_model_proto(data)
        if model.model_type not in (None, spm_model.MODEL_TYPE_BPE):
            raise ValueError(
                f"unsupported sentencepiece model_type {model.model_type} "
                "(only BPE models are supported, matching the reference's "
                "vocab_type='bpe' configs)"
            )
        control = [
            i for i, t in enumerate(model.types)
            if t in (spm_model.CONTROL, spm_model.UNUSED, spm_model.UNKNOWN)
            and i != UNK_ID
        ]
        tok = cls(model.pieces, [], piece_scores=model.scores,
                  control_ids=control)
        tok._proto_bytes = data
        return tok

    def to_sentencepiece_bytes(self) -> bytes:
        """Serialize as a sentencepiece ModelProto so the reference
        implementation can load tokenizers trained by this framework.
        Merge-list tokenizers get scores = -(merge rank) for merged pieces
        (the SP BPE trainer's convention), chars get lower scores."""
        if self.piece_scores is not None:
            scores = self.piece_scores
        else:
            merged_rank = {a + b: r for r, (a, b) in enumerate(self.merges)}
            n_merges = len(self.merges)
            scores = []
            char_rank = 0
            for i, p in enumerate(self.pieces):
                if i == UNK_ID:
                    scores.append(0.0)
                elif p in merged_rank:
                    scores.append(-float(merged_rank[p]))
                else:
                    scores.append(-float(n_merges + char_rank))
                    char_rank += 1
        types = [
            spm_model.UNKNOWN if i == UNK_ID
            else spm_model.CONTROL if i in self.control_ids
            else spm_model.NORMAL
            for i in range(len(self.pieces))
        ]
        return spm_model.serialize_model_proto(self.pieces, scores, types)


def train_bpe_native(corpus_path: str, vocab_size: int,
                     lowercase: bool = False) -> "BpeTokenizer | None":
    """Train with the C++ trainer (native/bpe_train.cpp), identical output
    to ``train_bpe`` (same merge rule and tie-break), built for corpus scale
    (the 40M-line LM corpus). None if the native library is unavailable."""
    try:
        pieces, merges = native.bpe_train(corpus_path, vocab_size, lowercase)
    except native.NativeUnavailable:
        return None
    return BpeTokenizer([UNK_PIECE] + pieces, merges)


def train_bpe(lines: Iterable[str], vocab_size: int) -> BpeTokenizer:
    """Train a BPE model: character alphabet + merges until vocab_size pieces
    (including <unk> at id 0) or no pair occurs twice."""
    word_freq = collections.Counter()
    for line in lines:
        for w in line.strip().split():
            word_freq[WORD_BOUNDARY + w] += 1

    words: List[List[str]] = [list(w) for w in word_freq]
    freqs: List[int] = [word_freq[w] for w in word_freq]

    alphabet = sorted({c for w in words for c in w})
    pieces = [UNK_PIECE] + alphabet
    merges: List[Tuple[str, str]] = []

    # pair counts + locations
    def count_pairs():
        pc = collections.Counter()
        for w, f in zip(words, freqs):
            for i in range(len(w) - 1):
                pc[(w[i], w[i + 1])] += f
        return pc

    pair_counts = count_pairs()
    while len(pieces) < vocab_size and pair_counts:
        (a, b), n = max(pair_counts.items(), key=lambda kv: (kv[1], kv[0]))
        if n < 2:
            break
        merges.append((a, b))
        pieces.append(a + b)
        new = a + b
        for wi, w in enumerate(words):
            if len(w) < 2:
                continue
            i = 0
            while i < len(w) - 1:
                if w[i] == a and w[i + 1] == b:
                    f = freqs[wi]
                    if i > 0:
                        pair_counts[(w[i - 1], a)] -= f
                        pair_counts[(w[i - 1], new)] += f
                    if i + 2 < len(w):
                        pair_counts[(b, w[i + 2])] -= f
                        pair_counts[(new, w[i + 2])] += f
                    w[i : i + 2] = [new]
                else:
                    i += 1
        pair_counts.pop((a, b), None)
        pair_counts = +pair_counts  # drop non-positive
    return BpeTokenizer(pieces, merges)
