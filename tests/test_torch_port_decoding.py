"""PyTorch port vs the JAX package: beam search and LM fusion, on the CPU.

The tie order of the selection helper against ``jax.lax.top_k``; the
fixed-capacity KV-cache step of the LM-Transformer (per-row positions)
against JAX ``LanguageModel.step`` and against the port's own teacher-forced
pass, and the LM-RNN's step; the host ARPA scorer and the device n-gram
scorer against the JAX package's on random walks over a synthetic 4-gram;
the CTC device beam against JAX ``ctc_beam_search_device`` (peaky and flat
log-probs, W 1/4/8, with and without the n-gram) and the host C++ beam
against JAX ``beam_search_batch``; and the Transducer device beam against
JAX ``beam_search_device`` on one tiny Transducer, in both routings, without
fusion and with the RNN LM, the Transformer LM and the n-gram. Weights come
from the JAX package's init (LMs, through utils/weights.from_jax) or from a
seeded generator (the Transducer, through utils/torch_compat); inputs from
numpy with fixed seeds. Tokens must be equal; logits within 1e-5, n-gram
scores within 1e-6 and n-gram states equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from efficientconformer_tpu.decoding import ctc_beam as jax_ctc_beam
from efficientconformer_tpu.decoding.ctc_beam_device import ctc_beam_search_device as jax_ctc_device
from efficientconformer_tpu.decoding.ngram import ArpaLM as JaxArpaLM
from efficientconformer_tpu.decoding.ngram_device import DeviceNgram as JaxDeviceNgram
from efficientconformer_tpu.decoding.rnnt_beam_device import beam_search_device as jax_rnnt_beam
from efficientconformer_tpu.models.lm import LanguageModel as JaxLM
from efficientconformer_torch.decoding import ctc_beam
from efficientconformer_torch.decoding.ctc_beam_device import ctc_beam_search_device
from efficientconformer_torch.decoding.ngram import ArpaLM
from efficientconformer_torch.decoding.ngram_device import DeviceNgram
from efficientconformer_torch.decoding.rnnt_beam_device import beam_search_device
from efficientconformer_torch.decoding.ties import argsort, top_k
from efficientconformer_torch.models.lm import LanguageModel
from efficientconformer_torch.utils.weights import from_jax
from ngram_synth import synth_arpa
from test_torch_port_transducer import jax_model_and_variables, narrow_transducer, port_transducer

VOCAB = 16
STEP_TOL = 1e-5      # fp32 LM step logits, the same arithmetic
NGRAM_TOL = 1e-6     # fp32 log10 sums of the same table entries
TRANSFORMER_LM = {"arch": "Transformer", "num_blocks": 2, "dim_model": 16, "ff_ratio": 2,
                  "num_heads": 2, "vocab_size": VOCAB, "relative_pos_enc": True,
                  "max_pos_encoding": 64, "Pdrop": 0.0}
RNN_LM = {"arch": "RNN", "num_layers": 1, "dim_model": 12, "vocab_size": VOCAB}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the beams run many tiny ops, and the test workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ tie order


@pytest.mark.parametrize("seed", range(3))
def test_top_k_breaks_ties_as_jax(seed):
    """Values drawn from a handful of levels, -1e30 among them, so that most
    entries tie: the same values and indices as jax.lax.top_k, the same
    order as the stable jnp.argsort, and the first maximum as jnp.argmax."""
    rng = np.random.default_rng(seed)
    levels = np.array([-1e30, -1e30, -3.5, 0.0, 0.0, 1.25], np.float32)
    x = levels[rng.integers(0, len(levels), (6, 40))]
    for k in (1, 4, 16, 40):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(argsort(torch.from_numpy(-x), 1).numpy(),
                                  np.asarray(jnp.argsort(-jnp.asarray(x), axis=1)))
    np.testing.assert_array_equal(torch.from_numpy(x).argmax(1).numpy(),
                                  np.asarray(jnp.argmax(jnp.asarray(x), axis=1)))


# ------------------------------------------------------------ LM steps


def jax_and_port_lm(params, seed=3):
    jm = JaxLM(lm_params=params, vocab_size=VOCAB)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed),
                                                 jnp.zeros((1, 4), jnp.int32), None, False))
    model = LanguageModel(params, VOCAB)
    model.load_state_dict(from_jax(variables), strict=True)
    return jm, variables, model.eval()


def test_fixed_cache_step_matches_jax_with_per_row_positions():
    """Rows advance different numbers of steps, the others fed dummies and
    keeping their old carry (as the beam's gathers make them): logits and
    caches of every step as JAX's."""
    jm, variables, model = jax_and_port_lm(TRANSFORMER_LM)
    seqs = [[3, 5], [7, 1, 4, 2, 9], [6], [0, 11, 15, 2]]
    b, cap = len(seqs), 8
    jc = jm.apply(variables, b, cap, method=JaxLM.init_carry_fixed)
    tc = model.init_carry_fixed(b, cap, "cpu")
    with torch.no_grad():
        for t in range(max(map(len, seqs))):
            live = np.array([t < len(s) for s in seqs])
            toks = np.array([s[t] if t < len(s) else 0 for s in seqs], np.int32)
            jl, jn = jm.apply(variables, jnp.asarray(toks), jc, method=JaxLM.step)
            tl, tn = model.step(torch.from_numpy(toks).long(), tc)
            np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], rtol=0,
                                       atol=STEP_TOL)
            m = jnp.asarray(live)
            jc = jax.tree.map(lambda n, o: jnp.where(m.reshape((b,) + (1,) * (n.ndim - 1)), n, o),
                              jn, jc)
            tm = torch.from_numpy(live)
            tc = {k: torch.where(tm.view((b,) + (1,) * (tn[k].dim() - 1)), tn[k], tc[k])
                  for k in tn}
            for i, want in enumerate(jc):      # the port stacks the blocks' caches
                np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(want["pos"]))
                for k in ("k", "v"):
                    np.testing.assert_allclose(tc[k][:, i].numpy(), np.asarray(want[k]), rtol=0,
                                               atol=STEP_TOL)


def test_fixed_cache_step_matches_the_teacher_forced_pass():
    """[blank, x_0, ...] stepped through the cache gives the port's own
    teacher-forced logits column by column."""
    _, _, model = jax_and_port_lm(TRANSFORMER_LM, seed=5)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(1, VOCAB, (2, 6))).long()
    with torch.no_grad():
        want = model(x)
        carry = model.init_carry_fixed(2, 9, "cpu")
        feed = torch.nn.functional.pad(x, (1, 0))
        for t in range(feed.shape[1]):
            logits, carry = model.step(feed[:, t], carry)
            torch.testing.assert_close(logits, want[:, t], rtol=0, atol=STEP_TOL)


def test_rnn_lm_step_matches_jax():
    jm, variables, model = jax_and_port_lm(RNN_LM, seed=7)
    jc = jm.apply(variables, 3, 9, method=JaxLM.init_carry_fixed)
    tc = model.init_carry_fixed(3, 9, "cpu")
    with torch.no_grad():
        for toks in ([0, 0, 0], [3, 9, 15], [1, 0, 4]):
            jl, jc = jm.apply(variables, jnp.asarray(toks, jnp.int32), jc, method=JaxLM.step)
            tl, tc = model.step(torch.tensor(toks), tc)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=STEP_TOL)


def test_growing_cache_step_raises():
    _, _, model = jax_and_port_lm(TRANSFORMER_LM)
    assert model.init_carry(2, "cpu") is None
    with pytest.raises(NotImplementedError, match="item 11"):
        model.step(torch.zeros(2, dtype=torch.long), None)


# ------------------------------------------------------------ n-gram scorers


@pytest.fixture(scope="module")
def arpa_path(tmp_path_factory):
    """A synthetic 4-gram over the 16 token characters: back-offs, <s>, and
    contexts of every order."""
    path = str(tmp_path_factory.mktemp("ngram") / "lm4.arpa")
    synth_arpa(path, vocab=VOCAB, order=4, counts=(0, 90, 160, 200), seed=1)
    return path


def random_walks(n, steps, seed, vocab=VOCAB):
    return np.random.default_rng(seed).integers(0, vocab + 2, (n, steps))  # 2 unknown ids


def test_arpa_lm_matches_jax(arpa_path):
    got, want = ArpaLM(arpa_path), JaxArpaLM(arpa_path)
    assert got.table == want.table and got.order == want.order == 4
    for walk in random_walks(20, 12, 0):
        s_got, s_want = got.start_state(), want.start_state()
        for tok in walk:
            (lp_got, s_got), (lp_want, s_want) = got.score(s_got, tok), want.score(s_want, tok)
            assert lp_got == lp_want and s_got == s_want


def test_device_ngram_matches_jax_and_the_host_scorer(arpa_path):
    """score_from and advance_node along random walks from <s>, and
    context_node of each walk's history: nodes equal to JAX's, scores within
    1e-6 of JAX's and of the host ArpaLM's."""
    host = ArpaLM(arpa_path)
    dev, jdev = DeviceNgram(host, VOCAB + 2, "cpu"), JaxDeviceNgram(JaxArpaLM(arpa_path),
                                                                   VOCAB + 2)
    assert (dev.score_max, dev.score_min) == pytest.approx((jdev.score_max, jdev.score_min))
    walks = random_walks(64, 14, 1)
    node, jnode = dev.start_state((64,)), jdev.start_state((64,))
    states = [host.start_state()] * 64
    for t in range(walks.shape[1]):
        tok = walks[:, t]
        sc, nxt = dev.score(node, torch.from_numpy(tok))
        jsc, jnxt = jdev.score(jnode, jnp.asarray(tok, jnp.int32))
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
        np.testing.assert_allclose(sc.numpy(), np.asarray(jsc), rtol=0, atol=NGRAM_TOL)
        host_sc = []
        for i in range(64):
            lp, states[i] = host.score(states[i], int(tok[i]))
            host_sc.append(lp)
        np.testing.assert_allclose(sc.numpy(), host_sc, rtol=0, atol=NGRAM_TOL)
        node, jnode = nxt, jnxt
        n_tok = np.full((64,), t + 1)
        ctx = dev.context_node(torch.from_numpy(walks), torch.from_numpy(n_tok))
        np.testing.assert_array_equal(ctx.numpy(), node.numpy())
        np.testing.assert_array_equal(
            ctx.numpy(), np.asarray(jdev.context_node(jnp.asarray(walks, jnp.int32),
                                                      jnp.asarray(n_tok, jnp.int32))))


# ------------------------------------------------------------ CTC beams


def random_log_probs(b, t, v, seed, peaky):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, v)) * (3.0 if peaky else 1.0)
    return (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)


@pytest.fixture(scope="module")
def ctc_arpa(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ngram") / "lm3.arpa")
    synth_arpa(path, vocab=7, order=3, counts=(0, 25, 40), seed=2)
    return path


@pytest.mark.parametrize("use_ngram", [False, True], ids=["acoustic", "ngram"])
@pytest.mark.parametrize("w", [1, 4, 8])
@pytest.mark.parametrize("peaky", [True, False], ids=["peaky", "flat"])
def test_ctc_device_beam_matches_jax(ctc_arpa, peaky, w, use_ngram):
    b, t, v = 3, 14, 7
    lp = random_log_probs(b, t, v, 10 * w + peaky, peaky)
    seq_len = np.array([t, t - 3, t - 6])
    kw = dict(alpha=0.4, beta=0.3) if use_ngram else {}
    want = jax_ctc_device(jnp.asarray(lp), jnp.asarray(seq_len), w,
                          ngram=JaxArpaLM(ctc_arpa) if use_ngram else None, **kw)
    got = ctc_beam_search_device(torch.from_numpy(lp), torch.from_numpy(seq_len), w,
                                 ngram=ArpaLM(ctc_arpa) if use_ngram else None, **kw)
    assert got == want
    if use_ngram:   # and both as the Python spec
        for i in range(b):
            assert got[i] == ctc_beam.ctc_prefix_beam_search(
                lp[i], int(seq_len[i]), w, lm=ArpaLM(ctc_arpa), **kw)


@pytest.mark.parametrize("cutoff_top_n", [0, 3])
def test_ctc_host_beam_matches_jax(ctc_arpa, cutoff_top_n):
    """The port's binding of native/ctc_beam.cpp and JAX's, with the n-gram
    and ctcdecode's cutoff_top_n; with the full vocabulary also the Python
    spec."""
    lp = random_log_probs(4, 16, 7, 3, peaky=False)
    seq_len = np.array([16, 12, 9, 16])
    kw = dict(lm_path=ctc_arpa, alpha=0.5, beta=0.2, cutoff_top_n=cutoff_top_n)
    got = ctc_beam.beam_search_batch(lp, seq_len, 4, **kw)
    assert got == jax_ctc_beam.beam_search_batch(lp, seq_len, 4, use_native=True, **kw)
    if cutoff_top_n == 0:
        lm = ArpaLM(ctc_arpa)
        assert got == [ctc_beam.ctc_prefix_beam_search(lp[i], int(seq_len[i]), 4, lm=lm,
                                                       alpha=0.5, beta=0.2) for i in range(4)]


# ------------------------------------------------------------ Transducer beams


def tones(b, n, seed, seg=640):
    """Waveforms of 40 ms tones of random pitch and loudness, so that the
    encoder's frames differ from each other."""
    rng = np.random.default_rng(seed)
    t = np.arange(seg) / 16000
    out = np.zeros((b, n), np.float32)
    for i in range(b):
        for s in range(0, n, seg):
            wave = rng.uniform(0.01, 1.0) * np.sin(2 * np.pi * rng.uniform(100, 6000) * t)
            out[i, s:s + seg] = wave[: n - s]
    return out


@pytest.fixture(scope="module")
def transducer(arpa_path):
    """A 2-block Transducer over 16 tokens with its JAX twin. The encoder
    projection of the joint is scaled by 4, so that the frames and not the
    decoder state choose the tokens, and the blank's bias raised by 5, so
    that the search meets both blank-coasting and contested frames."""
    cfg = narrow_transducer()
    cfg["encoder_params"].update(num_blocks=2, strided_blocks=[1], expand_blocks=[1],
                                 dim_model=[24, 36])
    model = port_transducer(cfg)
    with torch.no_grad():
        model.joint_network.linear_encoder.weight.mul_(4.0)
        model.joint_network.linear_joint.bias[0] += 5.0
    jm, jv = jax_model_and_variables(cfg, model)
    fusions = {"none": ({}, {})}
    for name, params in (("rnn", RNN_LM), ("transformer", TRANSFORMER_LM)):
        jlm, lv, lm = jax_and_port_lm(params, seed=11)
        fusions[name] = (dict(lm_model=jlm, lm_variables=lv, lm_weight=0.5, lm_tmp=1.5),
                         dict(lm_model=lm, lm_weight=0.5, lm_tmp=1.5))
    ng = dict(ngram_alpha=0.6, ngram_beta=0.4)
    fusions["ngram"] = (dict(ngram=JaxArpaLM(arpa_path), **ng), dict(ngram=ArpaLM(arpa_path), **ng))
    x, x_len = tones(2, 12000, 0), np.array([12000, 9000])
    return model, jm, jv, x, x_len, fusions


@pytest.mark.parametrize("fusion", ["none", "rnn", "transformer", "ngram"])
@pytest.mark.parametrize("ref_topk", [False, True], ids=["graves", "ref_topk"])
def test_transducer_device_beam_matches_jax(transducer, ref_topk, fusion):
    model, jm, jv, x, x_len, fusions = transducer
    jax_kw, port_kw = fusions[fusion]
    common = dict(beam_size=4, max_tokens=48, ref_topk=ref_topk)
    want = jax_rnnt_beam(jm, jv, jnp.asarray(x), jnp.asarray(x_len), **common, **jax_kw)
    stats = {}
    got = beam_search_device(model, torch.from_numpy(x), torch.from_numpy(x_len), stats=stats,
                             **common, **port_kw)
    assert got == want
    assert stats["slow_frames"] > 0 and stats["host_reads"] == 1 + stats["fast_frames"] + \
        stats["slow_frames"]
    if fusion == "none":    # the other fusions add to the fast path's bound
        assert stats["fast_frames"] > 0, stats
