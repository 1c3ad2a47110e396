"""ARPA n-gram language model scorer, the host side.

A copy of efficientconformer_tpu/decoding/ngram.py, kept here so that the
port imports nothing of the JAX package. It replaces the kenlm dependency
(reference models/transducer.py:50,198 and ctcdecode's internal scorer):
it reads standard ARPA files (the reference's ``6gram_256.arpa`` /
``6gram_1000.arpa``) and scores token transitions with back-off, with kenlm
BaseScore semantics (log10 probabilities, state = the last n-1 words).

The reference maps subword ids to unicode chars (chr(id + ngram_offset),
reference model_ctc.py:146, transducer.py:313), so the "words" of the ARPA
file are single characters; ``score(state, token_id)`` applies the same
mapping. decoding/ngram_device.py packs an ``ArpaLM`` into device tensors
for the device beams.
"""

from __future__ import annotations

import gzip
from typing import Dict, Optional, Tuple

LOG10_UNK = -10.0


class ArpaLM:
    def __init__(self, path: str, ngram_offset: int = 100):
        self.offset = ngram_offset
        # maps tuple(words) -> (logprob, backoff)
        self.table: Dict[Tuple[str, ...], Tuple[float, float]] = {}
        self.order = 0
        self._parse(path)

    def _parse(self, path: str) -> None:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            section = None
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("ngram "):
                    continue
                if line.startswith("\\"):
                    if line == "\\data\\" or line == "\\end\\":
                        section = None
                    elif line.endswith("-grams:"):
                        section = int(line[1:].split("-")[0])
                        self.order = max(self.order, section)
                    continue
                if section is None:
                    continue
                parts = line.split("\t")
                logp = float(parts[0])
                words = tuple(parts[1].split(" "))
                backoff = float(parts[2]) if len(parts) > 2 else 0.0
                self.table[words] = (logp, backoff)

    # ----------------------------------------------------------------- score

    def start_state(self) -> Tuple[str, ...]:
        """Null-context start (reference NullContextWrite)."""
        return ("<s>",) if ("<s>",) in self.table else ()

    def token_word(self, token_id: int) -> str:
        return chr(token_id + self.offset)

    def score_word(self, state: Tuple[str, ...], word: str) -> Tuple[float, Tuple[str, ...]]:
        """Back-off n-gram score of ``word`` in context ``state``.

        Returns (log10 prob, next state). Next state is the longest suffix of
        state+word that prefixes some entry (bounded by order-1).
        """
        context = state
        # find longest matching n-gram ending in word
        logp = None
        backoff_sum = 0.0
        for start in range(len(context) + 1):
            ngram = context[start:] + (word,)
            if ngram in self.table:
                logp = self.table[ngram][0]
                break
            # accumulate backoff of the context we failed to extend
            ctx = context[start:]
            if ctx in self.table:
                backoff_sum += self.table[ctx][1]
        if logp is None:
            uni = (word,)
            logp = self.table[uni][0] if uni in self.table else LOG10_UNK
        new_state = (state + (word,))[-(self.order - 1) :] if self.order > 1 else ()
        # trim state to longest prefix context present in the table
        while new_state and new_state not in self.table:
            new_state = new_state[1:]
        return logp + backoff_sum, new_state

    def score(self, state: Tuple[str, ...], token_id: int):
        return self.score_word(state, self.token_word(token_id))


_LOAD_CACHE: dict = {}


def try_load(path: Optional[str], ngram_offset: int = 100) -> Optional[ArpaLM]:
    """Load an ARPA model, memoised by (path, offset): the evaluation loop
    calls this per batch, and the device scorer's packing is memoised on
    the returned object's identity, so a fresh parse per batch would re-read
    the file and re-pack it. None (after a message) when the file is
    missing."""
    if not path:
        return None
    key = (path, ngram_offset)
    if key in _LOAD_CACHE:
        return _LOAD_CACHE[key]
    try:
        lm = ArpaLM(path, ngram_offset)
    except (FileNotFoundError, OSError):
        print("Ngram language model not found...")
        lm = None
    _LOAD_CACHE[key] = lm
    return lm
