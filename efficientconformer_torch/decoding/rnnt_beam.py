"""Transducer beam search on the host, with LM and n-gram fusion.

Counterpart of efficientconformer_tpu/decoding/rnnt_beam.py, the JAX
package's reference-semantics oracle (reference models/transducer.py
:188-326: Graves A/B hypothesis sets, best-hypothesis expansion until B
holds ``beam_size`` hypotheses a frame, length-normalised selection,
lm_weight * log-softmax fusion, ngram_alpha * score + ngram_beta rescoring
with per-hypothesis n-gram states). The CLI takes it with
``ECF_HOST_BEAM=1``: ``beam_search`` when a Transformer LM is fused (its
growing KV cache differs in length from hypothesis to hypothesis, so it
cannot be stacked across utterances), ``beam_search_batched`` otherwise.

The orchestration is the JAX package's, line for line, so that ties and
sums come out as there: hypothesis lists in Python, the first maximum of
``max(..., key=norm_score)``, ``list.remove`` and ``append`` in the same
order, the fused log-probs copied to numpy once a pop, numpy's own
``argsort`` for the top-k (stable under ``ref_topk``), scores accumulated
as Python floats, and the 3 W / 100 W expansion caps. Each pop is one
prediction-network step, one joint step and, with an LM, one LM step on
the device of the model; on the card the LM-Transformer's step runs the
bias-attention kernel at one query row against the growing cache.

Carries are the port's own: the RNN's (h, c), each (layers, B, H), and the
Transformer's growing cache, None before the first token and then a tuple
of one {"k", "v"} of (B, t, D) a block (models/decoders.py). A hypothesis
holds the carry from before its last token, and a pop replays that token.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F


@dataclass
class Hyp:
    prediction: List[int]
    logp_score: float
    hidden: object = None
    hidden_lm: object = None
    ngram_state: tuple = ()

    @property
    def norm_score(self) -> float:
        return self.logp_score / len(self.prediction)


def _fused_log_probs(model, f_t, g, tmp, lm_logits, lm_weight, lm_tmp) -> np.ndarray:
    """log_softmax(joint(f_t, g) / tmp) (+ lm_weight * log_softmax(lm_logits
    / lm_tmp)) in fp32, copied to the host: (..., V)."""
    logp = F.log_softmax((model.joint_step(f_t, g) / tmp).float(), dim=-1)
    if lm_logits is not None:
        logp = logp + lm_weight * F.log_softmax(lm_logits.float() / lm_tmp, dim=-1)
    return logp.cpu().numpy()


@torch.inference_mode()
def beam_search(model, x: torch.Tensor, x_len: torch.Tensor, *, beam_size: int = 16,
                tmp: float = 1.0, lm_model=None, lm_weight: float = 0.0, lm_tmp: float = 1.0,
                ngram=None, ngram_alpha: float = 0.0, ngram_beta: float = 0.0,
                ref_topk: bool = False, stats: Optional[dict] = None) -> List[List[int]]:
    """Token lists of waveforms x (B, T_audio) through a Transducer ``model``
    (models/transducer.py) in eval mode, one utterance at a time (JAX
    ``beam_search``). ``lm_model`` a LanguageModel (models/lm.py) fused with
    ``lm_weight``; ``ngram`` an ArpaLM (decoding/ngram.py) fused with
    ``ngram_alpha`` / ``ngram_beta``. ``ref_topk=True`` routes as the
    reference does: one top-``beam_size`` over the whole fused vocabulary a
    pop, the blank extending into B only when it is inside it; its
    expansion loop has no natural bound, so a cap of 100 W pops a frame
    raises. ``stats``, a dict, receives the pops and the best hypotheses'
    normalised scores."""
    dev = x.device
    f, f_len = model.encode(x, x_len)
    use_lm = lm_model is not None and bool(lm_weight)
    init_carry = model.decoder_init_carry(1, dev)
    pops = 0
    winners = []
    for b in range(x.shape[0]):
        beams = [Hyp(prediction=[0], logp_score=0.0, hidden=init_carry,
                     hidden_lm=lm_model.init_carry(1, dev) if lm_model is not None else None,
                     ngram_state=ngram.start_state() if ngram is not None else ())]
        for t in range(int(f_len[b])):
            a_hyps = beams
            beams = []
            expansions = 0
            max_exp = 100 * beam_size if ref_topk else 3 * beam_size
            while len(beams) < beam_size and expansions < max_exp:
                expansions += 1
                best = max(a_hyps, key=Hyp.norm_score.fget)
                a_hyps.remove(best)

                tok = torch.tensor([best.prediction[-1]], device=dev)
                g, hidden = model.decode_step(tok, best.hidden)
                lm_logits = hidden_lm = None
                if use_lm:
                    lm_logits, hidden_lm = lm_model.step(tok, best.hidden_lm)
                logp = _fused_log_probs(model, f[b:b + 1, t], g, tmp, lm_logits, lm_weight,
                                        lm_tmp)[0]
                pops += 1

                if ref_topk:
                    # the reference's routing: a top-k over the whole vocabulary
                    # (a stable descending sort: lowest index first on ties)
                    topk = np.argsort(-logp, kind="stable")[:beam_size]
                    if 0 in topk:
                        beams.append(Hyp(prediction=best.prediction[:],
                                         logp_score=best.logp_score + float(logp[0]),
                                         hidden=best.hidden, hidden_lm=best.hidden_lm,
                                         ngram_state=best.ngram_state))
                    topk = topk[topk != 0]
                else:
                    # the blank extension into B, always (Graves)
                    beams.append(Hyp(prediction=best.prediction[:],
                                     logp_score=best.logp_score + float(logp[0]),
                                     hidden=best.hidden, hidden_lm=best.hidden_lm,
                                     ngram_state=best.ngram_state))
                    # the top-k non-blank extensions into A
                    topk = np.argsort(logp[1:])[-beam_size:][::-1] + 1
                for c in topk:
                    c = int(c)
                    hyp = Hyp(prediction=best.prediction[:] + [c],
                              logp_score=best.logp_score + float(logp[c]),
                              hidden=hidden,
                              hidden_lm=hidden_lm if use_lm else best.hidden_lm,
                              ngram_state=best.ngram_state)
                    if ngram is not None and ngram_alpha:
                        sc, ns = ngram.score(best.ngram_state, c)
                        hyp.logp_score += ngram_alpha * sc + ngram_beta
                        hyp.ngram_state = ns
                    a_hyps.append(hyp)
            if ref_topk and len(beams) < beam_size:
                raise RuntimeError(
                    f"ref_topk beam search hit the expansion safety cap ({max_exp}) with only "
                    f"{len(beams)}/{beam_size} blank extensions: the reference's unbounded "
                    "loop would spin here; this model and input keep blank out of the top-k")
        winners.append(max(beams, key=Hyp.norm_score.fget))
    if stats is not None:
        stats.update(pops=pops, scores=[h.norm_score for h in winners])
    return [h.prediction[1:] for h in winners]


@torch.inference_mode()
def beam_search_batched(model, x: torch.Tensor, x_len: torch.Tensor, *, beam_size: int = 16,
                        tmp: float = 1.0, lm_model=None, lm_weight: float = 0.0,
                        lm_tmp: float = 1.0, ngram=None, ngram_alpha: float = 0.0,
                        ngram_beta: float = 0.0, ref_topk: bool = False,
                        stats: Optional[dict] = None) -> List[List[int]]:
    """``beam_search`` with the expansions batched across utterances (JAX
    ``beam_search_batched``): each utterance runs its own expansion loop,
    but every wave makes one prediction-network, joint and LM call over the
    whole batch, finished utterances fed dummy tokens. An LM's carry must
    stack across utterances (the RNN's); the growing cache of a
    Transformer LM goes through ``beam_search``. ``stats`` receives the
    pops (of the active utterances) and the best scores."""
    dev = x.device
    f, f_len = model.encode(x, x_len)
    bsz = x.shape[0]
    use_lm = lm_model is not None and bool(lm_weight)
    init_carry = model.decoder_init_carry(bsz, dev)
    lm_init_carry = lm_model.init_carry(bsz, dev) if use_lm else None

    beams = [[Hyp([0], 0.0, hidden=_take_batch(init_carry, b),
                  hidden_lm=_take_batch(lm_init_carry, b) if use_lm else None,
                  ngram_state=ngram.start_state() if ngram is not None else ())]
             for b in range(bsz)]
    t_ptr = [0] * bsz
    a_hyps: List[List[Hyp]] = [[] for _ in range(bsz)]
    new_beams: List[List[Hyp]] = [[] for _ in range(bsz)]
    expansions = [0] * bsz
    in_frame = [False] * bsz
    f_len_host = [int(v) for v in f_len.tolist()]
    rows = torch.arange(bsz, device=dev)
    pops = 0

    def frame_done(b):
        return t_ptr[b] >= f_len_host[b]

    while not all(frame_done(b) for b in range(bsz)):
        for b in range(bsz):
            if frame_done(b) or in_frame[b]:
                continue
            a_hyps[b] = beams[b]
            new_beams[b] = []
            expansions[b] = 0
            in_frame[b] = True

        # one expansion wave: pop each active utterance's best hypothesis
        active = [b for b in range(bsz) if in_frame[b] and not frame_done(b)]
        bests = {}
        for b in active:
            best = max(a_hyps[b], key=Hyp.norm_score.fget)
            a_hyps[b].remove(best)
            bests[b] = best

        toks = np.zeros((bsz,), np.int64)
        f_rows = np.zeros((bsz,), np.int64)
        for b in active:
            toks[b] = bests[b].prediction[-1]
            f_rows[b] = min(t_ptr[b], f.shape[1] - 1)
        toks_dev = torch.from_numpy(toks).to(dev)
        carry = _stack_carries([bests[b].hidden if b in bests else _take_batch(init_carry, 0)
                                for b in range(bsz)])
        g, hidden = model.decode_step(toks_dev, carry)
        lm_logits = lm_hidden = None
        if use_lm:
            lm_carry = _stack_carries(
                [bests[b].hidden_lm if b in bests else _take_batch(lm_init_carry, 0)
                 for b in range(bsz)])
            lm_logits, lm_hidden = lm_model.step(toks_dev, lm_carry)
        logp = _fused_log_probs(model, f[rows, torch.from_numpy(f_rows).to(dev)], g, tmp,
                                lm_logits, lm_weight, lm_tmp)
        pops += len(active)

        max_exp = 100 * beam_size if ref_topk else 3 * beam_size
        for b in active:
            best = bests[b]
            expansions[b] += 1
            hid_b = _take_batch(hidden, b)
            lm_hid_b = _take_batch(lm_hidden, b) if use_lm else None
            if ref_topk:
                topk = np.argsort(-logp[b], kind="stable")[:beam_size]
                if 0 in topk:
                    new_beams[b].append(Hyp(best.prediction[:],
                                            best.logp_score + float(logp[b, 0]),
                                            hidden=best.hidden, hidden_lm=best.hidden_lm,
                                            ngram_state=best.ngram_state))
                topk = topk[topk != 0]
            else:
                new_beams[b].append(Hyp(best.prediction[:], best.logp_score + float(logp[b, 0]),
                                        hidden=best.hidden, hidden_lm=best.hidden_lm,
                                        ngram_state=best.ngram_state))
                topk = np.argsort(logp[b, 1:])[-beam_size:][::-1] + 1
            for c in topk:
                c = int(c)
                hyp = Hyp(best.prediction[:] + [c], best.logp_score + float(logp[b, c]),
                          hidden=hid_b, hidden_lm=lm_hid_b if use_lm else best.hidden_lm,
                          ngram_state=best.ngram_state)
                if ngram is not None and ngram_alpha:
                    sc, ns = ngram.score(best.ngram_state, c)
                    hyp.logp_score += ngram_alpha * sc + ngram_beta
                    hyp.ngram_state = ns
                a_hyps[b].append(hyp)

            if len(new_beams[b]) >= beam_size or expansions[b] >= max_exp:
                if ref_topk and len(new_beams[b]) < beam_size:
                    raise RuntimeError(
                        f"ref_topk beam search hit the expansion safety cap ({max_exp}) with "
                        f"{len(new_beams[b])}/{beam_size} blank extensions")
                beams[b] = new_beams[b]
                t_ptr[b] += 1
                in_frame[b] = False

    winners = [max(bs, key=Hyp.norm_score.fget) for bs in beams]
    if stats is not None:
        stats.update(pops=pops, scores=[h.norm_score for h in winners])
    return [h.prediction[1:] for h in winners]


def _is_kv_cache(carry) -> bool:
    return isinstance(carry, tuple) and bool(carry) and isinstance(carry[0], dict)


def _take_batch(carry, idx: int):
    """Batch entry ``idx`` of a carry, keeping the axis: of the RNN's (h, c)
    along their middle axis (layers, B, H), of a growing cache's per-block
    {"k", "v"} along axis 0. None (a growing cache before its first token)
    stays None."""
    if carry is None:
        return None
    if _is_kv_cache(carry):
        return tuple({k: v[idx:idx + 1] for k, v in blk.items()} for blk in carry)
    return tuple(c[:, idx:idx + 1] for c in carry)


def _stack_carries(carries: list):
    """The carries of single utterances as one batch, in the layout
    ``_take_batch`` takes them from. Growing caches stack only at equal
    lengths."""
    first = carries[0]
    if first is None:
        return None
    if _is_kv_cache(first):
        return tuple({k: torch.cat([c[i][k] for c in carries], dim=0) for k in blk}
                     for i, blk in enumerate(first))
    return tuple(torch.cat([c[j] for c in carries], dim=1) for j in range(len(first)))
