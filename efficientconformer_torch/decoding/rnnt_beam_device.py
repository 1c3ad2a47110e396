"""Transducer beam search on the device, with LM and n-gram fusion.

Counterpart of efficientconformer_tpu/decoding/rnnt_beam_device.py: the
exact pop-for-pop beam of the host search (reference models/transducer.py
:188-326 semantics), lock-stepped across the batch.
  * Per frame, the best hypothesis of A (by length-normalised score, the
    earliest slot on ties, as Python's ``max`` over the hypothesis list) is
    popped; its blank extension is appended to B in arrival order, and its
    top-W token extensions to A (A holds W + W * W slots, since the host
    never prunes A within a frame). A frame makes exactly W pops (Graves).
  * A hypothesis keeps its decoder and LM state from BEFORE its last token,
    and a pop replays that token (the host's lagging convention).
  * The blank-coasting fast frame (exact): the replay products of a
    frame-initial hypothesis (decoder output, post-replay carries, LM
    log-softmax) depend on its tokens only, so each beam slot caches them.
    A frame starts with one batched joint over the cached outputs; if for
    every utterance the best token extension cannot outrank any
    frame-initial hypothesis, the W pops would pop exactly those in
    priority order and keep only their blanks, and the frame is that
    permutation and ``score += logp(blank)``, with no prediction-network
    work.
  * ``ref_topk``: the reference's raw top-k routing instead (one top-W over
    the whole fused vocabulary a pop; the blank extends into B only when it
    is inside it), up to 3 * W pops a frame, masked once an utterance's B is
    full; exact while every frame fills its B within the cap.
  * LM shallow fusion (reference transducer.py:260-273): logP += lm_weight *
    log_softmax(lm_logits / lm_tmp) over the whole vocabulary, through the
    LM's fixed-shape carry (``init_carry_fixed``: the RNN state or the
    Transformer's fixed-capacity KV cache).
  * n-gram rescoring of the chosen extensions (reference transducer.py
    :309-317) on the device scorer (decoding/ngram_device.py). Each slot
    carries its n-gram node, advanced as tokens are appended (the JAX
    package rebuilds it from the token buffer every pop; the two are equal,
    tests/test_ngram_device.py, and the carried node costs a few lookups
    instead of (order-1)^2).

What differs from the JAX package's layout, not its results:
  * Carries are kept once per pop, not once per slot. All W children of a
    pop share the popped hypothesis's post-replay carry, so a per-frame
    store holds the W frame-initial post-replay carries and one carry per
    pop, and every A slot holds an index into it. At full width the
    LM-Transformer's cache of 641 tokens is 47.3 MB a hypothesis (12 blocks,
    K and V of 768 fp32), so a frame holds W + pops caches per utterance
    (32 with Graves, 64 with ref_topk) instead of W + W * W + W.
  * A frame-initial pop takes its replay products from the slot's cache
    (the JAX package recomputes them, from the same inputs at the same
    shapes); so the carries from before the last token are never kept.
  * XLA keeps the nested loops on the device; here a frame's pops are a
    Python loop of fixed length (no read), and each frame reads one flag
    back to choose the fast or the slow frame, after one read of the frame
    count. ``stats`` counts the reads, fast and slow frames and pops.
  * On the card a pop's LM step and its n-gram rescoring each run as one
    CUDA graph of the same operations (decoding/graphs.py): eager PyTorch
    issues a launch at a time from the host, and the LM-Transformer's step
    alone is ~400 launches.

Ties break as in the JAX package (decoding/ties.py).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from efficientconformer_torch.decoding.graphs import leaves, on_card, tree_map
from efficientconformer_torch.decoding.ngram_device import as_device_ngram
from efficientconformer_torch.decoding.ties import argsort, top_k

NEG = -1.0e30


class _CarryStore:
    """Carries of one model (decoder or LM) in ``slots`` slots per
    utterance: each leaf (B, slots, ...), the batch axis of the model's
    layout moved to the front (an LSTM state is (layers, B, H))."""

    def __init__(self, init_carry, carry, w: int, slots: int):
        # the batch axis of each leaf: where a batch of 1 and of 2 differ
        one, two = init_carry(1), init_carry(2)
        self.axes = tree_map(
            lambda a, b: next(i for i, (m, n) in enumerate(zip(a.shape, b.shape)) if m != n),
            one, two)

        def alloc(leaf, ax):
            leaf = leaf.movedim(ax, 0)
            out = torch.empty((leaf.shape[0], slots) + leaf.shape[1:], dtype=leaf.dtype,
                              device=leaf.device)
            out[:, :w] = leaf[:, None]
            return out

        self.tree = tree_map(alloc, carry, self.axes)
        self.rows = torch.arange(leaves(self.tree)[0].shape[0], device=leaves(self.tree)[0].device)

    def gather(self, idx: torch.Tensor):
        """The carry of slot idx[b] of each utterance, in the model's layout."""
        return tree_map(lambda a, ax: a[self.rows, idx].movedim(0, ax), self.tree, self.axes)

    def put(self, slot: int, carry) -> None:
        def put(a, c, ax):
            a[:, slot] = c.movedim(ax, 0)
        tree_map(put, self.tree, carry, self.axes)

    def compact(self, src: torch.Tensor) -> None:
        """Slots [0, W) := slots src (B, W)."""
        def move(a):
            a[:, : src.shape[1]] = a[self.rows[:, None], src]
        tree_map(move, self.tree)

    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in leaves(self.tree))


@torch.inference_mode()
def beam_search_device(model, x: torch.Tensor, x_len: torch.Tensor, **kwargs):
    """Encode waveforms x (B, T_audio) and search: the decoded token lists
    (see ``beam_search_frames`` for the options)."""
    f, f_len = model.encode(x, x_len)
    return beam_search_frames(model, f, f_len, **kwargs)


@torch.inference_mode()
def beam_search_frames(model, f: torch.Tensor, f_len: torch.Tensor, *, beam_size: int = 16,
                       tmp: float = 1.0, max_tokens: int = 256, lm_model=None,
                       lm_weight: float = 0.0, lm_tmp: float = 1.0, ngram=None,
                       ngram_alpha: float = 0.0, ngram_beta: float = 0.0,
                       ref_topk: bool = False, stats: Optional[dict] = None,
                       return_scores: bool = False):
    """The beam over encoder frames f (B, T, De) with lengths f_len (B,) of
    a Transducer ``model`` (models/transducer.py) in eval mode: token lists,
    and with ``return_scores`` the best normalised scores (B,). ``lm_model``
    a LanguageModel (models/lm.py) fused with ``lm_weight``; ``ngram`` an
    ArpaLM or DeviceNgram fused with ``ngram_alpha`` / ``ngram_beta``.
    ``stats``, a dict, receives host reads, fast and slow frames, pops and
    the carry stores' bytes."""
    dev = f.device
    b, w = f.shape[0], beam_size
    vocab = model.joint_network.linear_joint.out_features
    ngram = as_device_ngram(ngram, vocab, dev) if ngram is not None and ngram_alpha else None
    use_lm = lm_model is not None and bool(lm_weight)
    pop_cap = 3 * w if ref_topk else w
    slots = w + pop_cap                   # frame-initial carries + one a pop
    rows = torch.arange(b, device=dev)
    ar_w = torch.arange(w, device=dev)[None, :].expand(b, w)
    f_len = f_len.to(dev)
    if ngram is not None:
        # exact static bound on one extension's n-gram term, for the fast path
        ng_bound = ngram_beta + ngram_alpha * (ngram.score_max if ngram_alpha >= 0
                                               else ngram.score_min)

    def dec_init(n):
        return model.decoder_init_carry(n, dev, max_tokens + 1)

    zeros_tok = torch.zeros((b,), dtype=torch.long, device=dev)
    # the replay of the start hypothesis (blank on the initial carry),
    # cached into every initial slot as a later pop would cache it
    g0, nc0 = model.decode_step(zeros_tok, dec_init(b))
    dec_store = _CarryStore(dec_init, nc0, w, slots)
    beams = {
        "score": torch.where(ar_w == 0, 0.0, NEG),
        "tokens": torch.zeros((b, w, max_tokens), dtype=torch.long, device=dev),
        "n_tok": torch.zeros((b, w), dtype=torch.long, device=dev),
        "last_tok": torch.zeros((b, w), dtype=torch.long, device=dev),
        "g": g0[:, None].expand(b, w, g0.shape[-1]).clone(),
        "cslot": ar_w.clone(),            # store slot of the post-replay carries
    }
    if use_lm:
        def lm_init(n):
            return lm_model.init_carry_fixed(n, max_tokens + 1, dev)

        lm_logits0, lm_nc0 = lm_model.step(zeros_tok, lm_init(b))
        lm_store = _CarryStore(lm_init, lm_nc0, w, slots)
        lm_step = on_card(lm_model.step, zeros_tok, lm_nc0)
        lm_lp0 = F.log_softmax(lm_logits0.float() / lm_tmp, dim=-1)
        beams["lm_lp"] = lm_lp0[:, None].expand(b, w, vocab).clone()
    if ngram is not None:
        beams["node"] = ngram.start_state((b, w))
        ng_score = on_card(ngram.score, beams["node"], ar_w + 1)
    st = {"host_reads": 0, "fast_frames": 0, "slow_frames": 0, "pops": 0,
          "carry_store_bytes": dec_store.nbytes() + (lm_store.nbytes() if use_lm else 0)}

    def frame_inputs(f_t, active, bm):
        """The fused extension log-probs of every frame-initial hypothesis
        from the cached replay products (one batched joint), their
        priorities, and the exact fast-frame predicate."""
        f_w = f_t[:, None].expand(b, w, f_t.shape[-1])
        fused0 = F.log_softmax((model.joint_step(f_w, bm["g"]) / tmp).float(), dim=-1)
        if use_lm:
            fused0 = fused0 + lm_weight * bm["lm_lp"]
        valid = bm["score"] > NEG / 2
        n_f = bm["n_tok"].float()
        prio = torch.where(valid, bm["score"] / (1.0 + n_f), NEG)
        best_tok_lp = fused0[..., 1:].max(-1).values
        if ngram is not None:
            best_tok_lp = best_tok_lp + ng_bound
        child_prio = torch.where(valid & (bm["n_tok"] < max_tokens),
                                 (bm["score"] + best_tok_lp) / (2.0 + n_f), NEG)
        fast_b = valid.all(1) & (child_prio.max(1).values <= prio.min(1).values)
        if ref_topk:
            # the blank (index 0, which wins value ties) must also be inside
            # the top W of every frame-initial hypothesis
            n_greater = (fused0[..., 1:] > fused0[..., :1]).sum(-1)
            fast_b = fast_b & (n_greater <= w - 1).all(1)
        return fused0, prio, (fast_b | ~active).all()

    def keep(active, new, old):
        return {k: torch.where(active.view((b,) + (1,) * (new[k].dim() - 1)), new[k], old[k])
                for k in new}

    def fast_frame(bm, active, fused0, prio):
        """The W pops would pop the frame-initial beams in priority order
        (the earliest slot on ties) and keep only their blank extensions."""
        order = argsort(-prio, dim=1)
        nb = {k: v.gather(1, order.view(order.shape + (1,) * (v.dim() - 2)).expand_as(v))
              for k, v in bm.items()}
        nb["score"] = (bm["score"] + fused0[..., 0]).gather(1, order)
        return keep(active, nb, bm)

    def slow_frame(bm, f_t, active, fused0):
        """The exact sequential pops. A pop of a child replays its last
        token through the prediction network (and the LM) from its lagging
        carry; a pop of a frame-initial hypothesis takes its cached
        products, and its extension log-probs from ``fused0``."""
        pad = pop_cap * w
        a = {"score": torch.cat([bm["score"], torch.full((b, pad), NEG, device=dev)], 1),
             "cidx": torch.cat([bm["cslot"], torch.zeros((b, pad), dtype=torch.long,
                                                         device=dev)], 1)}
        for k in ("tokens", "n_tok", "last_tok") + (("node",) if ngram is not None else ()):
            a[k] = torch.cat([bm[k], bm[k].new_zeros((b, pad) + bm[k].shape[2:])], 1)
        pool = {k: torch.zeros_like(v) for k, v in bm.items()}
        pool["score"].fill_(NEG)
        b_count = torch.zeros((b,), dtype=torch.long, device=dev)
        for e in range(pop_cap):
            # utterances still filling their B (Graves: every pop emits)
            frame_active = active & (b_count < w)
            prio_a = torch.where(a["score"] > NEG / 2,
                                 a["score"] / (1.0 + a["n_tok"].float()), NEG)
            p = prio_a.argmax(1)
            pop = {k: v[rows, p] for k, v in a.items()}
            # an utterance not filling its B leaves its pool as it is, so
            # its A need not be kept either
            a["score"][rows, p] = NEG
            is_ini = p < w
            p_ini = p.clamp(max=w - 1)
            post = torch.where(is_ini, bm["cslot"][rows, p_ini], w + e)
            g_c, nc = model.decode_step(pop["last_tok"], dec_store.gather(pop["cidx"]))
            dec_store.put(w + e, nc)
            g = torch.where(is_ini[:, None], bm["g"][rows, p_ini], g_c)
            logp = F.log_softmax((model.joint_step(f_t, g_c) / tmp).float(), dim=-1)
            logp = torch.where(is_ini[:, None], fused0[rows, p_ini], logp)
            entry = {"tokens": pop["tokens"], "n_tok": pop["n_tok"],
                     "last_tok": pop["last_tok"], "g": g, "cslot": post}
            if use_lm:
                lm_logits, lm_nc = lm_step(pop["last_tok"], lm_store.gather(pop["cidx"]))
                lm_store.put(w + e, lm_nc)
                lm_lp = F.log_softmax(lm_logits.float() / lm_tmp, dim=-1)
                logp = torch.where(is_ini[:, None], logp, logp + lm_weight * lm_lp)
                entry["lm_lp"] = torch.where(is_ini[:, None], bm["lm_lp"][rows, p_ini], lm_lp)
            entry["score"] = pop["score"] + logp[:, 0]

            # routing: the labels that extend into A, and whether the pop
            # emits its blank extension into B
            if ref_topk:
                tok_lp, toks = top_k(logp, w)
                blank_pos = toks == 0
                emit = blank_pos.any(1) & frame_active
            else:
                tok_lp, toks = top_k(logp[:, 1:], w)
                toks = toks + 1
                blank_pos = torch.zeros_like(toks, dtype=torch.bool)
                emit = frame_active

            # the blank extension -> B slot b_count, its replay products cached
            if ngram is not None:
                entry["node"] = pop["node"]
            at = b_count.clamp(max=w - 1)
            for k, val in entry.items():
                m = emit.view((b,) + (1,) * (val.dim() - 1))
                pool[k][rows, at] = torch.where(m, val, pool[k][rows, at])

            # the top-W token extensions -> A slots [w + e*w, w + (e+1)*w),
            # their lagging carry the popped hypothesis's post-replay one
            if ngram is not None:
                ng, child_node = ng_score(pop["node"][:, None].expand(b, w), toks)
                tok_lp = tok_lp + ngram_alpha * ng + ngram_beta
            child_scores = torch.where((pop["n_tok"] < max_tokens)[:, None] & ~blank_pos,
                                       pop["score"][:, None] + tok_lp, NEG)
            n_new = pop["n_tok"].clamp(max=max_tokens - 1)
            child_tokens = pop["tokens"][:, None].expand(b, w, max_tokens).clone()
            child_tokens.scatter_(2, n_new.view(b, 1, 1).expand(b, w, 1), toks[..., None])
            s = slice(w + e * w, w + (e + 1) * w)
            a["score"][:, s] = child_scores
            a["tokens"][:, s] = child_tokens
            a["n_tok"][:, s] = (pop["n_tok"] + 1)[:, None]
            a["last_tok"][:, s] = toks
            a["cidx"][:, s] = post[:, None]
            if ngram is not None:
                a["node"][:, s] = child_node
            b_count = b_count + emit.long()
        st["pops"] += pop_cap
        nb = keep(active, pool, bm)
        # the new beams' post-replay carries to slots [0, W)
        dec_store.compact(nb["cslot"])
        if use_lm:
            lm_store.compact(nb["cslot"])
        nb["cslot"] = ar_w.clone()
        return nb

    n_frames = int(f_len.max())
    st["host_reads"] += 1
    for t in range(n_frames):
        # one frame for every utterance still inside its length
        f_t, active = f[:, t], t < f_len
        fused0, prio, fast = frame_inputs(f_t, active, beams)
        st["host_reads"] += 1
        if bool(fast):
            st["fast_frames"] += 1
            beams = fast_frame(beams, active, fused0, prio)
        else:
            st["slow_frames"] += 1
            beams = slow_frame(beams, f_t, active, fused0)

    # length-normalised pick (reference transducer.py:326: the leading blank
    # makes len(prediction) = 1 + tokens); the earliest slot wins ties
    norm = torch.where(beams["score"] > NEG / 2,
                       beams["score"] / (1.0 + beams["n_tok"].float()), NEG)
    best = norm.argmax(1)
    tokens = beams["tokens"][rows, best].cpu()
    n_tok = beams["n_tok"][rows, best].cpu()
    if stats is not None:
        stats.update(st)
    out: List[List[int]] = [tokens[i, : n_tok[i]].tolist() for i in range(b)]
    if return_scores:
        return out, norm.max(1).values.cpu()
    return out
