"""CTC prefix beam search on the host, with optional n-gram fusion.

Counterpart of efficientconformer_tpu/decoding/ctc_beam.py, which replaces
the ctcdecode C++ extension (reference model_ctc.py:138-181): prefix beam
search over (T, V) log-probabilities with kenlm-style scoring, alpha *
log10 P_lm + beta per emitted token (the ctcdecode convention of the
configs' ngram_alpha / ngram_beta).

``ctc_prefix_beam_search`` is the Python spec, a dict of prefixes per
utterance; the tests hold the other searches to it. ``beam_search_batch``
runs native/ctc_beam.cpp through data/native.py, with ctcdecode's
``cutoff_top_n`` pruning: it is what ``ECF_HOST_BEAM=1`` selects in the
CLI. Without a C++ compiler it raises ``NativeUnavailable``; it does not
run the Python spec instead.
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from efficientconformer_torch.data import native
from efficientconformer_torch.decoding.ngram import ArpaLM

LOG0 = -1e30


def _logaddexp(a: float, b: float) -> float:
    if a < b:
        a, b = b, a
    if b <= LOG0 / 2:
        return a
    return a + math.log1p(math.exp(b - a))


def ctc_prefix_beam_search(log_probs: np.ndarray, seq_len: int, beam_size: int = 16,
                           blank: int = 0, lm: Optional[ArpaLM] = None, alpha: float = 0.0,
                           beta: float = 0.0, cutoff_top_n: Optional[int] = None) -> List[int]:
    """The best token sequence of one utterance's (T, V) natural-log
    probabilities."""
    # beams: prefix tuple -> (p_blank, p_nonblank, lm_state, lm_score)
    start_state = lm.start_state() if lm is not None else ()
    beams = {(): (0.0, LOG0, start_state, 0.0)}
    v = log_probs.shape[1]
    top_n = min(cutoff_top_n or v, v)

    for t in range(seq_len):
        lp = log_probs[t]
        cand = np.argsort(lp)[-top_n:] if top_n < v else range(v)
        next_beams: dict = {}

        def get(prefix, state):
            if prefix not in next_beams:
                next_beams[prefix] = [LOG0, LOG0, state, 0.0]
            return next_beams[prefix]

        def extend(state, lm_sc, c):
            if lm is not None and alpha:
                w_lp, state = lm.score(state, c)
                return state, lm_sc + alpha * w_lp + beta
            return state, lm_sc

        for prefix, (pb, pnb, state, lm_sc) in beams.items():
            p_tot = _logaddexp(pb, pnb)
            for c in cand:
                c = int(c)
                p = float(lp[c])
                if c == blank:
                    e = get(prefix, state)
                    e[0] = _logaddexp(e[0], p_tot + p)
                    e[2], e[3] = state, lm_sc
                    continue
                if prefix and c == prefix[-1]:
                    # a repeat without blank extends the same prefix's non-blank
                    e = get(prefix, state)
                    e[1] = _logaddexp(e[1], pnb + p)
                    e[2], e[3] = state, lm_sc
                    # with a blank in between it is a new prefix
                    ns, nsc = extend(state, lm_sc, c)
                    e2 = get(prefix + (c,), ns)
                    e2[1] = _logaddexp(e2[1], pb + p)
                    e2[2], e2[3] = ns, nsc
                else:
                    ns, nsc = extend(state, lm_sc, c)
                    e = get(prefix + (c,), ns)
                    e[1] = _logaddexp(e[1], p_tot + p)
                    e[2], e[3] = ns, nsc

        # prune to beam_size by the total (acoustic + lm) score
        scored = sorted(next_beams.items(),
                        key=lambda kv: _logaddexp(kv[1][0], kv[1][1]) + kv[1][3],
                        reverse=True)[:beam_size]
        beams = {k: tuple(vv) for k, vv in scored}

    best = max(beams.items(), key=lambda kv: _logaddexp(kv[1][0], kv[1][1]) + kv[1][3])
    return list(best[0])


def beam_search_batch(log_probs: np.ndarray, seq_lens: np.ndarray, beam_size: int = 16,
                      lm_path: Optional[str] = None, alpha: float = 0.0, beta: float = 0.0,
                      ngram_offset: int = 100, cutoff_top_n: int = 0,
                      num_workers: int = 8) -> List[List[int]]:
    """The C++ beam over a batch (B, T, V) of natural-log probabilities,
    utterances spread over ``num_workers`` threads (the C++ search releases
    the interpreter lock; the reference's num_processes=8). A missing
    ``lm_path`` file decodes without the n-gram, after a message, as the
    JAX package does."""
    lm = None
    if lm_path:
        try:
            lm = native.NativeArpa(lm_path, ngram_offset)
        except FileNotFoundError:
            print("Ngram language model not found...")

    def one(b):
        return native.ctc_beam_search(log_probs[b], int(seq_lens[b]), beam_size, 0, lm, alpha,
                                      beta, cutoff_top_n)

    n = log_probs.shape[0]
    if num_workers > 1 and n > 1:
        with ThreadPoolExecutor(max_workers=num_workers) as ex:
            return list(ex.map(one, range(n)))
    return [one(b) for b in range(n)]
