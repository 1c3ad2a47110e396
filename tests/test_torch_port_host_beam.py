"""PyTorch port vs the JAX package: the growing KV cache and the host
Transducer beams, on the CPU.

The LM-Transformer's growing-cache step (``step(y, None)``, then the tuple
of per-block caches) against JAX ``LanguageModel.step`` on its growing
cache, against the port's fixed-capacity step and against its
teacher-forced pass; the host beams ``beam_search`` and
``beam_search_batched`` against JAX's on one tiny Transducer, without
fusion and with the RNN LM, the Transformer LM (per utterance only, as the
runtime routes it) and the n-gram, in both routings; and the batched beam
against the per-utterance one (tests/test_beam_batched.py's cases). Weights
come from the JAX package's init (LMs, through utils/weights.from_jax) or a
seeded generator (the Transducer); inputs from numpy with fixed seeds.
Tokens must be equal; logits and caches within 1e-5.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from efficientconformer_tpu.decoding import rnnt_beam as jax_beam
from efficientconformer_tpu.decoding.ngram import ArpaLM as JaxArpaLM
from efficientconformer_tpu.models.lm import LanguageModel as JaxLM
from efficientconformer_torch.decoding import rnnt_beam
from efficientconformer_torch.decoding.ngram import ArpaLM
from ngram_synth import synth_arpa
from test_torch_port_decoding import RNN_LM, TRANSFORMER_LM, jax_and_port_lm, tones
from test_torch_port_transducer import jax_model_and_variables, narrow_transducer, port_transducer

STEP_TOL = 1e-5      # fp32 LM step logits and caches, the same arithmetic


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lms():
    """The RNN and Transformer LMs of both packages, from one JAX init."""
    return {name: jax_and_port_lm(params, seed=11)
            for name, params in (("rnn", RNN_LM), ("transformer", TRANSFORMER_LM))}


# ------------------------------------------------------------ growing cache


def test_growing_cache_step_matches_jax_and_the_fixed_cache(lms):
    """Six tokens stepped from None: logits and every block's k and v as
    JAX's growing cache, logits as the port's fixed-capacity step."""
    jm, variables, model = lms["transformer"]
    tokens = np.random.default_rng(0).integers(1, 16, (3, 6)).astype(np.int32)
    jax_step = jax.jit(functools.partial(jm.apply, method=JaxLM.step))
    jc, tc = None, None
    fixed = model.init_carry_fixed(3, 8, "cpu")
    assert model.init_carry(3, "cpu") is None
    with torch.no_grad():
        for t in range(tokens.shape[1]):
            tok = tokens[:, t]
            jl, jc = jax_step(variables, jnp.asarray(tok), jc)
            tl, tc = model.step(torch.from_numpy(tok).long(), tc)
            fl, fixed = model.step(torch.from_numpy(tok).long(), fixed)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=STEP_TOL)
            torch.testing.assert_close(tl, fl, rtol=0, atol=STEP_TOL)
            assert len(tc) == len(jc) == TRANSFORMER_LM["num_blocks"]
            for got, want in zip(tc, jc):
                for k in ("k", "v"):
                    assert got[k].shape == (3, t + 1, TRANSFORMER_LM["dim_model"])
                    np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0,
                                               atol=STEP_TOL)


def test_growing_cache_matches_the_teacher_forced_pass_and_is_not_written_in_place(lms):
    """[blank, x_0, ...] stepped through the growing cache gives the
    teacher-forced logits column by column; a step leaves the cache it was
    given as it was (hypotheses share caches)."""
    model = lms["transformer"][2]
    x = torch.from_numpy(np.random.default_rng(2).integers(1, 16, (2, 6))).long()
    with torch.no_grad():
        want = model(x)
        feed = torch.nn.functional.pad(x, (1, 0))
        carry = None
        for t in range(feed.shape[1]):
            before = None if carry is None else [{k: v.clone() for k, v in blk.items()}
                                                 for blk in carry]
            logits, new = model.step(feed[:, t], carry)
            torch.testing.assert_close(logits, want[:, t], rtol=0, atol=STEP_TOL)
            if carry is not None:
                for blk, old in zip(carry, before):
                    assert all(torch.equal(blk[k], old[k]) for k in blk)
            carry = new


# ------------------------------------------------------------ host beams


@pytest.fixture(scope="module")
def transducer(tmp_path_factory, lms):
    """2-block Transducers over 16 tokens with their JAX twins, the joint's
    encoder projection scaled by 4 and the blank's bias raised by 5 (as
    tests/test_torch_port_decoding.py's) or, for the Transformer LM, by 12:
    shorter hypotheses, as the JAX beam compiles that LM's step once for
    each cache length. Then the fusions of both packages, and the inputs."""
    arpa = str(tmp_path_factory.mktemp("ngram") / "lm4.arpa")
    synth_arpa(arpa, vocab=16, order=4, counts=(0, 90, 160, 200), seed=1)
    cfg = narrow_transducer()
    cfg["encoder_params"].update(num_blocks=2, strided_blocks=[1], expand_blocks=[1],
                                 dim_model=[24, 36])

    def pair(blank_bias):
        model = port_transducer(cfg)
        with torch.no_grad():
            model.joint_network.linear_encoder.weight.mul_(4.0)
            model.joint_network.linear_joint.bias[0] += blank_bias
        return (model, *jax_model_and_variables(cfg, model))

    models = {"none": pair(5.0)}
    models["rnn"] = models["ngram"] = models["none"]
    models["transformer"] = pair(12.0)
    fusions = {"none": ({}, {})}
    for name, (jlm, lv, lm) in lms.items():
        fusions[name] = (dict(lm_model=jlm, lm_variables=lv, lm_weight=0.5, lm_tmp=1.5),
                         dict(lm_model=lm, lm_weight=0.5, lm_tmp=1.5))
    ng = dict(ngram_alpha=0.6, ngram_beta=0.4)
    fusions["ngram"] = (dict(ngram=JaxArpaLM(arpa), **ng), dict(ngram=ArpaLM(arpa), **ng))
    x, x_len = tones(2, 12000, 0), np.array([12000, 9000])
    return models, x, x_len, fusions


@pytest.mark.parametrize("fn,fusion,ref_topk", [
    (fn, fusion, False) for fn in ("beam_search", "beam_search_batched")
    for fusion in ("none", "rnn", "transformer", "ngram")
    if (fn, fusion) != ("beam_search_batched", "transformer")] + [
    ("beam_search", "none", True), ("beam_search", "ngram", True),
    ("beam_search_batched", "rnn", True)])
def test_host_beam_matches_jax(transducer, fn, fusion, ref_topk):
    """Each fusion through each beam in the Graves routing, and the
    reference's top-k routing on three of them (the Transformer LM's JAX
    step compiles once for each cache length, so it runs once)."""
    models, x, x_len, fusions = transducer
    model, jm, jv = models[fusion]
    jax_kw, port_kw = fusions[fusion]
    want = getattr(jax_beam, fn)(jm, jv, jnp.asarray(x), jnp.asarray(x_len), beam_size=3,
                                 ref_topk=ref_topk, **jax_kw)
    stats = {}
    got = getattr(rnnt_beam, fn)(model, torch.from_numpy(x), torch.from_numpy(x_len),
                                 beam_size=3, ref_topk=ref_topk, stats=stats, **port_kw)
    assert got == want
    assert stats["pops"] >= 3 * 10          # W pops a frame at least, 10 frames and more
    assert any(len(t) for t in got)


@pytest.mark.parametrize("fusion,beam", [("none", 3), ("rnn", 3), ("ngram", 2)])
def test_batched_beam_matches_per_sample(transducer, fusion, beam):
    models, x, x_len, fusions = transducer
    model = models[fusion][0]
    port_kw = fusions[fusion][1]
    x, x_len = torch.from_numpy(x), torch.from_numpy(x_len)
    want = rnnt_beam.beam_search(model, x, x_len, beam_size=beam, **port_kw)
    assert rnnt_beam.beam_search_batched(model, x, x_len, beam_size=beam, **port_kw) == want


def test_carry_layouts_round_trip():
    """_take_batch and _stack_carries over the RNN's (layers, B, H) state
    and the growing cache's per-block {"k", "v"} of (B, t, D)."""
    rnn = (torch.randn(2, 3, 5), torch.randn(2, 3, 5))
    cache = tuple({"k": torch.randn(3, 4, 6), "v": torch.randn(3, 4, 6)} for _ in range(2))
    for carry in (rnn, cache):
        parts = [rnnt_beam._take_batch(carry, b) for b in range(3)]
        back = rnnt_beam._stack_carries(parts)
        flat = (lambda c: [t for blk in c for t in blk.values()]) if carry is cache else list
        assert all(torch.equal(a, b) for a, b in zip(flat(back), flat(carry)))
    assert rnnt_beam._take_batch(None, 1) is None and rnnt_beam._stack_carries([None]) is None
