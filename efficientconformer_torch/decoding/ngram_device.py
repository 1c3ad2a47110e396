"""The ARPA n-gram scorer on device tensors, for the device beams' fusion.

Counterpart of efficientconformer_tpu/decoding/ngram_device.py. The model is
packed into sorted integer tensors so that the back-off recursion of
``ArpaLM.score_word`` runs on the card, vectorised over beam slots:
  * a NODE is a context present in the table (any entry of order < N, and
    the empty context, node 0); the LM state of a hypothesis is one int64
    node id, which beam slots stack and gather like any other field;
  * per node: its back-off weight, its longest proper suffix node (the
    back-off chain) and its length;
  * scores: every entry whose context is a node, under the key
    node * (n_words + 1) + wid, sorted once at packing time; a lookup is
    one ``torch.searchsorted`` and one compare. (The JAX package bisects a
    CSR row in ~10 unrolled steps of ~6 ops each, because a searchsorted
    inside its beam's loops compiled badly on the TPU; in eager PyTorch each
    op is a launch, so one searchsorted a lookup is the cheaper form of the
    same search. A word the ARPA file lacks maps to wid n_words, which no key
    holds.)
  * transitions: the same keys map (node(t[:-1]), t[-1]) -> node(t) for
    every non-empty node, which gives the longest-suffix state update.

Score and state semantics equal ``ArpaLM.score_word``'s for well-formed ARPA
files (every entry's context is itself listed, as kenlm and SRILM write
them); tests/test_torch_port_decoding.py holds the two, and this module to
the JAX package's, on synthetic 6-grams.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from efficientconformer_torch.decoding.ngram import LOG10_UNK, ArpaLM


def _sorted_keys(nodes, wids, vals, n_words: int, device, dtype):
    """(keys, vals): node * (n_words + 1) + wid, ascending, as device
    tensors; the keys are unique because the table's n-grams are."""
    keys = np.asarray(nodes, np.int64) * (n_words + 1) + np.asarray(wids, np.int64)
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    return (torch.from_numpy(keys).to(device),
            torch.from_numpy(np.asarray(vals)[order]).to(device=device, dtype=dtype))


class DeviceNgram:
    def __init__(self, arpa: ArpaLM, vocab_size: int, device):
        device = torch.device(device)
        self.order = max(arpa.order, 1)
        words = sorted({w for key in arpa.table for w in key})
        word_id = {w: i for i, w in enumerate(words)}
        self.n_words = len(words)

        # ---- nodes: contexts (entries of order < N) and the empty context
        node_tuples = [()] + sorted(k for k in arpa.table if len(k) < self.order)
        node_id = {t: i for i, t in enumerate(node_tuples)}
        n_nodes = len(node_tuples)
        backoff = np.zeros((n_nodes,), np.float32)
        suffix = np.zeros((n_nodes,), np.int64)
        length = np.zeros((n_nodes,), np.int64)
        for t, i in node_id.items():
            if t in arpa.table:
                backoff[i] = arpa.table[t][1]
            length[i] = len(t)
            s = t[1:]
            while s and s not in node_id:
                s = s[1:]
            suffix[i] = node_id[s] if s else 0

        # ---- scores of every entry whose context is a node
        snodes, swids, svals = [], [], []
        max_logp, min_logp, max_bo, min_bo = LOG10_UNK, 0.0, 0.0, 0.0
        for t, (logp, bo) in arpa.table.items():
            max_logp, min_logp = max(max_logp, logp), min(min_logp, logp)
            max_bo, min_bo = max(max_bo, bo), min(min_bo, bo)
            ctx = t[:-1]
            if ctx not in node_id:
                continue  # ill-formed entry: unreachable from trimmed states
            snodes.append(node_id[ctx])
            swids.append(word_id[t[-1]])
            svals.append(logp)
        self.score_keys, self.score_vals = _sorted_keys(
            snodes, swids, np.asarray(svals, np.float32), self.n_words, device, torch.float32)

        # ---- transitions (node(t[:-1]), t[-1]) -> node(t)
        tnodes, twids, tvals = [], [], []
        for t, i in node_id.items():
            if t and t[:-1] in node_id:
                tnodes.append(node_id[t[:-1]])
                twids.append(word_id[t[-1]])
                tvals.append(i)
        self.trans_keys, self.trans_vals = _sorted_keys(
            tnodes, twids, np.asarray(tvals, np.int64), self.n_words, device, torch.int64)

        self.backoff = torch.from_numpy(backoff).to(device)
        self.suffix = torch.from_numpy(suffix).to(device)
        self.length = torch.from_numpy(length).to(device)
        # token id -> wid through the chr(id + offset) word convention
        tok_wid = np.full((vocab_size,), self.n_words, np.int64)
        for tok in range(vocab_size):
            tok_wid[tok] = word_id.get(chr(tok + arpa.offset), self.n_words)
        self.token_wid = torch.from_numpy(tok_wid).to(device)
        self.device = device
        self.n_entries = len(svals)
        bos = ("<s>",)
        self._start = node_id.get(bos, 0) if bos in arpa.table else 0
        # exact static bounds on one score: log-prob plus up to order-1
        # back-off additions (the Transducer beam's blank-coasting bound)
        self.score_max = max_logp + (self.order - 1) * max(0.0, max_bo)
        self.score_min = min(LOG10_UNK, min_logp) + (self.order - 1) * min(0.0, min_bo)

    def nbytes(self) -> int:
        """Bytes of the packed tables on the device."""
        return sum(t.numel() * t.element_size() for t in (
            self.score_keys, self.score_vals, self.trans_keys, self.trans_vals, self.backoff,
            self.suffix, self.length, self.token_wid))

    def start_state(self, shape) -> torch.Tensor:
        """Node ids of the start context (<s> if the table has it)."""
        return torch.full(shape, self._start, dtype=torch.long, device=self.device)

    def _lookup(self, keys, vals, node, wid, default):
        """(value, hit) of key (node, wid) in the sorted ``keys``."""
        if keys.numel() == 0:
            return torch.full(node.shape, default, dtype=vals.dtype, device=node.device), \
                torch.zeros(node.shape, dtype=torch.bool, device=node.device)
        q = node * (self.n_words + 1) + wid
        idx = torch.searchsorted(keys, q.reshape(-1)).reshape(q.shape).clamp_(max=keys.numel() - 1)
        hit = keys[idx] == q
        return torch.where(hit, vals[idx], default), hit

    def score_from(self, node: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
        """Back-off log10 score of ``tok`` in context ``node``, any shape
        (``ArpaLM.score_word``'s log-prob)."""
        wid = self.token_wid[tok]
        cur = node
        acc = torch.zeros(node.shape, device=node.device)
        done = torch.zeros(node.shape, dtype=torch.bool, device=node.device)
        out = torch.zeros(node.shape, device=node.device)
        for _ in range(self.order):
            val, hit = self._lookup(self.score_keys, self.score_vals, cur, wid, 0.0)
            out = torch.where(~done & hit, val + acc, out)
            done = done | hit
            acc = acc + torch.where(done, 0.0, self.backoff[cur])
            at_root = cur == 0
            # fell off the chain without a hit: the unknown-word score
            out = torch.where(~done & at_root, LOG10_UNK + acc, out)
            done = done | at_root
            cur = self.suffix[cur]
        return out

    def advance_node(self, node: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
        """The state update: node of the longest table suffix of context + tok."""
        if self.order == 1:
            return torch.zeros_like(node)
        wid = self.token_wid[tok]
        cur = torch.where(self.length[node] >= self.order - 1, self.suffix[node], node)
        new_node = torch.zeros_like(node)
        found = torch.zeros(node.shape, dtype=torch.bool, device=node.device)
        for _ in range(self.order - 1):
            val, hit = self._lookup(self.trans_keys, self.trans_vals, cur, wid, 0)
            new_node = torch.where(~found & hit, val, new_node)
            found = found | hit
            cur = torch.where(found | (cur == 0), cur, self.suffix[cur])
        return new_node

    def score(self, node: torch.Tensor, tok: torch.Tensor):
        """(score, next node): ``ArpaLM.score``'s semantics."""
        return self.score_from(node, tok), self.advance_node(node, tok)

    def context_node(self, tokens: torch.Tensor, n_tok: torch.Tensor) -> torch.Tensor:
        """The state node of a token history: tokens (..., U), n_tok (...,)
        valid counts. It depends on the last order-1 tokens only, except
        that a history shorter than that starts from <s>: the state the
        incremental ``advance_node`` reaches."""
        k = self.order - 1
        if k == 0:
            return torch.zeros(n_tok.shape, dtype=torch.long, device=n_tok.device)
        node = torch.where(n_tok < k, self._start, 0)
        for i in range(k, 0, -1):
            pos = n_tok - i
            tok = tokens.gather(-1, pos.clamp(min=0)[..., None])[..., 0]
            node = torch.where(pos >= 0, self.advance_node(node, tok), node)
        return node


_CONVERT_CACHE: dict = {}


def as_device_ngram(ngram, vocab_size: int, device) -> Optional[DeviceNgram]:
    """``ngram`` (an ArpaLM, a DeviceNgram or None) as a DeviceNgram on
    ``device``, packed once per source model, vocabulary and device (the
    evaluation loop asks for it every batch)."""
    if ngram is None or isinstance(ngram, DeviceNgram):
        return ngram
    key = (id(ngram), vocab_size, str(torch.device(device)))
    hit = _CONVERT_CACHE.get(key)
    if hit is None:
        # hold the source ArpaLM too, so that its id() cannot be reused
        hit = _CONVERT_CACHE[key] = (DeviceNgram(ngram, vocab_size, device), ngram)
    return hit[0]
