"""Word error rate (replaces the jiwer dependency of reference models/model.py).

A copy of efficientconformer_tpu/utils/metrics.py, kept here so that the
port imports nothing of the JAX package; tests/test_torch_port_data.py holds
the two to equal results.

The reference computes ``jiwer.wer(truths, preds, standardize=True)``
(reference model.py:425,483). Its era of jiwer (2.3-2.5 — ``standardize`` was
removed in jiwer 3.0, so the unpinned requirements.txt only resolves against
2.x) does, for each sentence pair:

  ToLowerCase -> ExpandCommonEnglishContractions -> RemoveKaldiNonWords ->
  RemoveWhiteSpace(replace_by_space) -> RemoveMultipleSpaces -> Strip ->
  ReduceToListOfListOfWords

then sums substitutions/deletions/insertions over the sentence PAIRS and
divides by the total reference word count (order-invariant — which also makes
the number independent of the multi-host gather order, unlike jiwer <=2.2's
single concatenated-corpus alignment).

This module reimplements exactly that: the same transform chain (including
jiwer's substring contraction rules — "'s" -> " is" even for possessives —
applied in jiwer's dict order) and the per-pair Levenshtein sum.
"""

from __future__ import annotations

from typing import List, Sequence

# jiwer 2.x ExpandCommonEnglishContractions: plain substring substitutions,
# applied in this order (the regexes contain no metacharacters beyond an
# escaped quote). NB "won't" -> "will not" must run before "n't" -> " not".
_CONTRACTIONS = [
    ("won't", "will not"),
    ("can't", "can not"),
    ("let's", "let us"),
    ("n't", " not"),
    ("'re", " are"),
    ("'s", " is"),
    ("'d", " would"),
    ("'ll", " will"),
    ("'t", " not"),
    ("'ve", " have"),
    ("'m", " am"),
]


def _edit_distance(ref: Sequence[str], hyp: Sequence[str]) -> int:
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        for j in range(1, m + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[m]


def _standardize_words(s: str) -> List[str]:
    """jiwer 2.x ``wer_standardize`` transform chain -> list of words."""
    s = s.lower()
    for pat, rep in _CONTRACTIONS:
        s = s.replace(pat, rep)
    # RemoveKaldiNonWords (regex [<\[][^>\]]*[>\]]): an opener < or [ up to
    # the FIRST > or ] after it, whichever comes first
    out, i = [], 0
    while i < len(s):
        if s[i] in "<[":
            closers = [j for j in (s.find(">", i + 1), s.find("]", i + 1))
                       if j != -1]
            if closers:
                i = min(closers) + 1
                continue
        out.append(s[i])
        i += 1
    s = "".join(out)
    # whitespace -> space, collapse, strip, split
    return s.split()


def _words(s: str) -> List[str]:
    return s.lower().split()


def wer(truths: Sequence[str], preds: Sequence[str],
        standardize: bool = True) -> float:
    """Corpus-level WER: total per-pair edits / total reference words
    (jiwer 2.3+ ``compute_measures`` aggregation; reference model.py:483).

    ``standardize=True`` (the reference's setting) applies the full jiwer
    ``wer_standardize`` chain; ``False`` is plain lowercase+split.
    """
    assert len(truths) == len(preds)
    to_words = _standardize_words if standardize else _words
    edits = 0
    n_words = 0
    for t, p in zip(truths, preds):
        tw, pw = to_words(t), to_words(p)
        edits += _edit_distance(tw, pw)
        n_words += len(tw)
    return edits / max(n_words, 1)
