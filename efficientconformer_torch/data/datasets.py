"""Datasets (reference utils/datasets.py).

LibriSpeech is described by a *manifest* per split — one JSON line per
utterance {audio, audio_len, labels} — written by ``preparation.prepare_dataset``
(replacing the reference's per-file ``torch.save`` caches next to each flac).
Length filtering (train_audio_max_length / train_label_max_length,
reference datasets.py:51-61) happens at manifest load.

``LibriSpeechCorpusDataset`` streams the 40M-line LM corpus, tokenizing on the
fly and resampling lines over max_len like the reference (datasets.py:72-78).

The counterpart of efficientconformer_tpu/data/datasets.py: the same
manifests, filters, corpus index and resampling.
"""

from __future__ import annotations

import glob
import json
import os
import random
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from efficientconformer_torch.data.audio_io import load_audio
from efficientconformer_torch.data.tokenizer import BpeTokenizer


@dataclass
class Utterance:
    audio_path: str
    audio_len: int
    labels: List[int]

    @property
    def label_len(self) -> int:
        return len(self.labels)


def manifest_path(dataset_path: str, split: str, vocab_type: str, vocab_size: int) -> str:
    return os.path.join(
        dataset_path, f"manifest_{split}_{vocab_type}_{vocab_size}.jsonl"
    )


class LibriSpeechDataset:
    """Manifest-backed audio+label dataset.

    split examples: "train-clean-100", "dev-clean", "test-other", or the
    aggregate "train" (all train-* manifests).
    """

    def __init__(
        self,
        dataset_path: str,
        split: str,
        *,
        vocab_type: str = "bpe",
        vocab_size: int = 256,
        audio_max_length: Optional[int] = None,
        label_max_length: Optional[int] = None,
        lm_mode: bool = False,
    ):
        # lm_mode: labels-only dataset for LM evaluation on transcripts
        # (reference utils/datasets.py:33,42-43)
        self.lm_mode = lm_mode
        paths = sorted(
            glob.glob(manifest_path(dataset_path, split + "*", vocab_type, vocab_size))
        )
        if not paths:
            raise FileNotFoundError(
                f"no manifest for split {split!r} under {dataset_path}; "
                "run prepare_dataset first"
            )
        self.utterances: List[Utterance] = []
        for p in paths:
            with open(p) as f:
                for line in f:
                    d = json.loads(line)
                    u = Utterance(d["audio"], d["audio_len"], d["labels"])
                    if audio_max_length is not None and u.audio_len > audio_max_length:
                        continue
                    if label_max_length is not None and u.label_len > label_max_length:
                        continue
                    self.utterances.append(u)

    def __len__(self):
        return len(self.utterances)

    def __getitem__(self, i: int):
        u = self.utterances[i]
        if self.lm_mode:
            return np.asarray(u.labels, np.int32)
        audio, _sr = load_audio(u.audio_path)
        return audio, np.asarray(u.labels, np.int32)

    @property
    def max_label_len(self) -> int:
        return max((u.label_len for u in self.utterances), default=1)


def _corpus_index(corpus_path: str) -> np.ndarray:
    """Line-start byte offsets of a text corpus, as an int64 memmap.

    Built once by streaming the file (no whole-file read) and cached next to
    it as ``<corpus>.idx`` (a raw little-endian int64 array with one trailing
    entry = file size, so line i spans [idx[i], idx[i+1])). The cache is
    rebuilt if the corpus is newer. Memory cost at runtime is O(1): the index
    itself is memory-mapped — the 40M-line LM corpus costs ~320 MB of *file*,
    zero resident requirement, instead of the ~4 GB a readlines() needs."""
    idx_path = corpus_path + ".idx"
    if (not os.path.isfile(idx_path)
            or os.path.getmtime(idx_path) < os.path.getmtime(corpus_path)):
        tmp = idx_path + ".tmp"
        with open(corpus_path, "rb") as f, open(tmp, "wb") as out:
            pos = 0
            starts = [0]
            while True:
                chunk = f.read(1 << 24)
                if not chunk:
                    break
                at = chunk.find(b"\n")
                while at >= 0:
                    starts.append(pos + at + 1)
                    at = chunk.find(b"\n", at + 1)
                pos += len(chunk)
                if len(starts) >= (1 << 20):
                    # keep the newest entry so the trailing-newline check at
                    # EOF always sees it
                    out.write(np.asarray(starts[:-1], np.int64).tobytes())
                    starts = starts[-1:]
            if starts and starts[-1] == pos:
                starts.pop()  # file ends with '\n': no empty final line
            starts.append(pos)  # EOF sentinel: line i spans [idx[i], idx[i+1])
            out.write(np.asarray(starts, np.int64).tobytes())
        os.replace(tmp, idx_path)
    return np.memmap(idx_path, np.int64, mode="r")


class LibriSpeechCorpusDataset:
    """Text corpus for LM training: tokenize on the fly, resample lines that
    exceed max_len (reference utils/datasets.py:64-82).

    The reference ``readlines()``s the whole 40M-line corpus into RAM
    (reference utils/datasets.py:67); here lines are fetched through a
    memory-mapped offset index (O(1) resident memory) and encoded through the
    native BPE fast path when available."""

    def __init__(self, corpus_path: str, tokenizer: BpeTokenizer,
                 max_len: Optional[int] = None, seed: int = 0):
        self._index = _corpus_index(corpus_path)
        self._file = open(corpus_path, "rb")
        self.tokenizer = tokenizer
        self.max_len = max_len
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self._index) - 1

    def line(self, i: int) -> str:
        start, end = int(self._index[i]), int(self._index[i + 1])
        self._file.seek(start)
        return self._file.read(end - start).decode("utf-8").rstrip("\n")

    def __getitem__(self, i: int):
        while True:
            ids = self.tokenizer.encode(self.line(i).lower())
            if self.max_len is None or len(ids) <= self.max_len:
                return np.asarray(ids, np.int32)
            i = self.rng.randrange(len(self))
