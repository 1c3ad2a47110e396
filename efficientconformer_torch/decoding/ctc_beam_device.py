"""CTC prefix beam search on the device, with optional n-gram fusion.

Counterpart of efficientconformer_tpu/decoding/ctc_beam_device.py. The host
searches (decoding/ctc_beam.py: the Python spec and native/ctc_beam.cpp,
which replace the reference's ctcdecode, reference model_ctc.py:138-181)
walk a prefix dict per utterance. CTC beam search is frame-synchronous, so
here it is vectorised over (batch, W) beams: one Python loop over the
padded frames, each frame masked by ``active`` (t < seq_len), with no read
back to the host until the result; on the card each frame is one CUDA
graph replay of its operations (decoding/graphs.py).

Exact prefix merge without a dict: the W live beams always hold distinct
prefixes (an invariant of the pruning below), so the only merge the dict
makes is "extension of beam i by token c equals beam j's prefix" (beams 'A'
and 'AB': 'A' + B folds into 'AB''s non-blank mass). A (W, W) parent matrix
per frame finds it, ``eq[j, i] = len_j == len_i + 1 and prefix_j[:len_i] ==
prefix_i``, with at most one parent per beam; the extensions absorbed this
way leave the candidate pool, so every pool entry is a distinct prefix and
the top-W pruning keeps the invariant.

N-gram fusion scores ``alpha * log10 P(c | prefix) + beta`` per emitted
token (the ctcdecode convention the host spec follows) with the device
scorer (decoding/ngram_device.py); the LM state is one node per beam,
advanced on extension. Ties break as in the JAX package (decoding/ties.py).
No ``cutoff_top_n``: the full vocabulary is scored, as in the JAX package.
"""

from __future__ import annotations

from typing import List

import torch

from efficientconformer_torch.decoding.graphs import on_card
from efficientconformer_torch.decoding.ngram_device import as_device_ngram
from efficientconformer_torch.decoding.ties import top_k

LOG0 = -1e30


def _logaddexp(a, b):
    m = torch.maximum(a, b)
    m_safe = m.clamp(min=LOG0 / 2)
    return torch.where(m <= LOG0 / 2, LOG0,
                       m + torch.log1p(torch.exp(torch.minimum(a, b) - m_safe)))


def ctc_beam_search_device(log_probs: torch.Tensor, seq_len: torch.Tensor,
                           beam_size: int = 16, blank: int = 0, ngram=None,
                           alpha: float = 0.0, beta: float = 0.0) -> List[List[int]]:
    """The best token sequence of each utterance of natural-log
    probabilities ``log_probs`` (B, T, V) fp32 with lengths ``seq_len``
    (B,), on their device; ``ngram`` an ArpaLM or DeviceNgram."""
    pref, plen, score = prefix_beams(log_probs, seq_len, beam_size, blank, ngram, alpha, beta)
    best = score.argmax(-1)              # the first of equal scores, as jnp.argmax
    rows = torch.arange(pref.shape[0], device=pref.device)
    tokens, n_tok = pref[rows, best].cpu(), plen[rows, best].cpu()
    return [tokens[i, : n_tok[i]].tolist() for i in range(tokens.shape[0])]


@torch.inference_mode()
def prefix_beams(log_probs: torch.Tensor, seq_len: torch.Tensor, beam_size: int = 16,
                 blank: int = 0, ngram=None, alpha: float = 0.0, beta: float = 0.0):
    """The search without reading anything back: the final beams as
    device tensors, prefixes (B, W, U), their lengths (B, W) and their
    total scores (B, W) (acoustic + LM; -1e30 for an empty slot)."""
    b, t_max, v = log_probs.shape
    dev = log_probs.device
    ngram = as_device_ngram(ngram, v, dev) if ngram is not None and alpha else None
    u_cap = t_max                          # a prefix grows at most a token a frame
    w = beam_size
    rows = torch.arange(b, device=dev)[:, None]
    slots = torch.arange(w, device=dev)[None, :]
    vocab = torch.arange(v, device=dev)[None, None, :]
    pos_u = torch.arange(u_cap, device=dev)[None, None, None, :]
    seq_len = seq_len.to(dev)

    # slot 0 holds the empty prefix (p_blank = 1), the others are invalid
    state = {"pref": torch.zeros((b, w, u_cap), dtype=torch.long, device=dev),
             "plen": torch.zeros((b, w), dtype=torch.long, device=dev),
             "pb": torch.where(slots == 0, 0.0, LOG0).expand(b, w).clone(),
             "pnb": torch.full((b, w), LOG0, device=dev),
             "lmsc": torch.zeros((b, w), device=dev)}
    if ngram is not None:
        state["node"] = ngram.start_state((b, w))

    def frame(st, lp, active):
        """One frame: state dict, log-probs lp (B, V), active (B, 1) ->
        the next state (an inactive utterance keeps its own)."""
        pref, plen, pb, pnb, lmsc = st["pref"], st["plen"], st["pb"], st["pnb"], st["lmsc"]
        ptot = _logaddexp(pb, pnb)
        valid = ptot > LOG0 / 2
        last = torch.where(plen > 0, pref.gather(-1, (plen - 1).clamp(min=0)[..., None])[..., 0],
                           -1)                              # (B, W), -1 when empty
        p_last = lp.gather(-1, last.clamp(min=0))

        # ---- the same prefix: blank, and a repeat without blank
        pb_new = ptot + lp[:, blank][:, None]
        pnb_same = torch.where(plen > 0, pnb + p_last, LOG0)

        # ---- parent matrix: eq[b, j, i] = prefix_j == prefix_i + last_j
        within = pos_u < plen[:, None, :, None]
        match = ((pref[:, :, None, :] == pref[:, None, :, :]) | ~within).all(-1)
        eq = ((plen[:, :, None] == plen[:, None, :] + 1) & match
              & valid[:, None, :] & valid[:, :, None])
        has_par = eq.any(-1)
        par = eq.int().argmax(-1)                           # the first parent
        par_last = last.gather(-1, par)
        ext_into = torch.where(
            has_par, torch.where(last == par_last, pb.gather(-1, par), ptot.gather(-1, par))
            + p_last, LOG0)
        pnb_new = _logaddexp(pnb_same, ext_into)
        score_same = _logaddexp(pb_new, pnb_new) + lmsc

        # ---- extensions (i, c): the new prefix is prefix_i + c
        ext_pnb = torch.where(vocab == last[..., None], pb[..., None], ptot[..., None]) \
            + lp[:, None, :]                                # (B, W, V)
        if ngram is not None:
            lm_add = alpha * ngram.score_from(st["node"][..., None].expand(b, w, v),
                                              vocab.expand(b, w, v)) + beta
        else:
            lm_add = torch.zeros((b, w, v), device=dev)
        ext_score = ext_pnb + (lmsc[..., None] + lm_add)
        # absorbed[i, c]: some beam j already is prefix_i + c
        absorbed = torch.zeros((b, w, v), dtype=torch.int32, device=dev)
        absorbed.index_put_((rows.expand(b, w), torch.where(has_par, par, 0), last.clamp(min=0)),
                            (has_par & (last >= 0)).int(), accumulate=True)
        dead = (absorbed > 0) | (vocab == blank) | ~valid[..., None]
        ext_score = ext_score.masked_fill(dead, LOG0)

        # ---- prune: top W of [W same] ++ [W * V extensions]
        pool = torch.cat([score_same, ext_score.reshape(b, w * v)], dim=-1)
        top_score, top_idx = top_k(pool, w)                 # (B, W)
        is_same = top_idx < w
        ext_idx = (top_idx - w).clamp(min=0)
        src = torch.where(is_same, top_idx, ext_idx // v)   # the source beam
        tok = torch.where(is_same, 0, ext_idx % v)          # the extension token

        new_pref = pref.gather(1, src[..., None].expand(b, w, u_cap))
        new_plen = plen.gather(-1, src)
        at = new_plen.clamp(max=u_cap - 1)
        cur = new_pref.gather(-1, at[..., None])[..., 0]
        new_pref.scatter_(-1, at[..., None], torch.where(is_same, cur, tok)[..., None])
        alive = top_score > LOG0 / 2       # entries that fell off the pool stay invalid
        new_pnb = torch.where(is_same, pnb_new.gather(-1, src),
                              ext_pnb.reshape(b, w * v).gather(-1, ext_idx))
        new = {"pref": new_pref, "plen": new_plen + (~is_same).long(),
               "pb": torch.where(is_same & alive, pb_new.gather(-1, src), LOG0),
               "pnb": torch.where(alive, new_pnb, LOG0),
               "lmsc": lmsc.gather(-1, src) + torch.where(
                   is_same, 0.0, lm_add.reshape(b, w * v).gather(-1, ext_idx))}
        if ngram is not None:
            src_node = st["node"].gather(-1, src)
            new["node"] = torch.where(is_same, src_node, ngram.advance_node(src_node, tok))
        return {k: torch.where(active.view((b,) + (1,) * (x.dim() - 1)), x, st[k])
                for k, x in new.items()}

    step = on_card(frame, state, log_probs[:, 0].float(), seq_len[:, None] > 0)
    for t in range(t_max):
        state = step(state, log_probs[:, t].float(), (t < seq_len)[:, None])
    pref, plen = state["pref"].clone(), state["plen"].clone()
    return pref, plen, _logaddexp(state["pb"], state["pnb"]) + state["lmsc"]
