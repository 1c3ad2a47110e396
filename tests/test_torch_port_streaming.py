"""PyTorch port vs the JAX package: streaming, on the CPU in fp32.

The pieces the causal and limited-context encoders add (the full-window
skew, the grouped relative window, the causal strided depthwise conv, the
attention's skewing paths with fully masked rows), the causal and the
limited-context encoder, the window geometry on every config, the greedy
Transducer loop run window by window, and the overlap-save sessions. The
port's variables reach it through utils/weights.from_jax (loaded with
strict=True); inputs come from numpy with fixed seeds. One JAX model per
config is shared by the module, since JAX compiles each streaming geometry
once.
"""

import glob
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from efficientconformer_tpu import streaming as JS
from efficientconformer_tpu.config import encoder_output_frames
from efficientconformer_tpu.models.attentions import MultiHeadSelfAttention as JaxMHSA
from efficientconformer_tpu.models.layers import Conv1d as JaxConv1d
from efficientconformer_tpu.models.model_ctc import ModelCTC as JaxModelCTC
from efficientconformer_tpu.models.transducer import Transducer as JaxTransducer
from efficientconformer_tpu.models.transducer import greedy_decode_stream as jax_decode_stream
from efficientconformer_tpu.ops import attention as JA
from efficientconformer_tpu.ops import masks as JM
from efficientconformer_tpu.ops import pos_enc as JP
from efficientconformer_tpu.utils import torch_compat as TC
from efficientconformer_torch import streaming as S
from efficientconformer_torch.models import transducer as T
from efficientconformer_torch.models.attentions import MultiHeadSelfAttention
from efficientconformer_torch.models.layers import Conv1d
from efficientconformer_torch.models.model_ctc import ModelCTC, init_params_
from efficientconformer_torch.ops import attention as A
from efficientconformer_torch.ops import pos_enc as P
from efficientconformer_torch.utils.weights import from_jax
from test_torch_port_model import perturb_norms_
from test_torch_port_rel_attention import jax_mhsa_params, port_mhsa
from tests.test_models import TINY_DEC, TINY_ENC, TINY_JOINT
from tests.test_streaming_runtime import CAUSAL_ENC, ECF_SHAPED

VOCAB = 9
LAYER_TOL = 1e-5        # one attention layer or conv, fp32
LOGITS_TOL = 1e-4       # the bound of tests/test_torch_parity.py, after every block
CAUSAL_STREAM_TOL = 2e-5    # streamed vs batch frames, tests/test_streaming_runtime.py:92
FINITE_STREAM_TOL = 1e-4    # the same over its 6-block finite-context stack (:286)
FINITE_ENC = dict(ECF_SHAPED, left_context=16, right_context=2)
CHUNK, LOOK = 9, 2      # the JAX streaming tests' geometry


class Pair:
    """A JAX model with its variables and the port's model holding them: the
    weights are drawn by the port (norms and BatchNorm statistics moved off
    their init), taken to the JAX package by utils/torch_compat and brought
    back by from_jax into a fresh port model with strict=True."""

    def __init__(self, kind, enc, seed):
        gen = torch.Generator().manual_seed(seed)
        if kind == "ctc":
            self.jax = JaxModelCTC(encoder_params=enc, vocab_size=VOCAB)
            src, self.port = ModelCTC(enc, VOCAB), ModelCTC(enc, VOCAB)
            convert = TC.convert_ctc
        else:
            self.jax = JaxTransducer(encoder_params=enc, decoder_params=TINY_DEC,
                                     joint_params=TINY_JOINT, vocab_size=VOCAB)
            src = T.Transducer(enc, TINY_DEC, TINY_JOINT, VOCAB)
            self.port = T.Transducer(enc, TINY_DEC, TINY_JOINT, VOCAB)
            convert = TC.convert_transducer
        init_params_(src, gen)
        perturb_norms_(src, seed + 1)
        params, stats = convert(src.state_dict())
        self.variables = {"params": jax.tree.map(jnp.asarray, params),
                          "batch_stats": jax.tree.map(jnp.asarray, stats)}
        self.port.load_state_dict(from_jax(self.variables), strict=True)
        self.port.eval()
        self.enc = enc
        if kind == "ctc":
            self.jax_encode = jax.jit(lambda a, n: self.jax.apply(self.variables, a, n, False))
            self.port_encode = self.port
        else:
            self.jax_encode = jax.jit(lambda a, n: self.jax.apply(
                self.variables, a, n, False, method=JaxTransducer.encode))
            self.port_encode = self.port.encode


@pytest.fixture(scope="module")
def causal_ctc():
    return Pair("ctc", CAUSAL_ENC, 0)


@pytest.fixture(scope="module")
def finite_ctc():
    return Pair("ctc", FINITE_ENC, 5)


@pytest.fixture(scope="module")
def causal_transducer():
    return Pair("transducer", CAUSAL_ENC, 2)


def audio_batch(b, t, cut, seed):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((b, t)) * 0.1).astype(np.float32)
    x_len = np.array([t] + [t - cut] * (b - 1), np.int64)
    return audio, x_len


# ------------------------------------------------------------ the pieces


@pytest.mark.parametrize("t,th", [(1, 0), (4, 0), (7, 0), (5, 3)])
def test_rel_to_abs_full_matches_jax(t, th):
    x = np.random.default_rng(t + th).standard_normal((2, 3, t, th + 2 * t - 1))
    x = x.astype(np.float32)
    want = JA.rel_to_abs_full(jnp.asarray(x))
    got = A.rel_to_abs_full(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("g", [1, 3, 5])
@pytest.mark.parametrize("causal", [False, True])
def test_grouped_relative_encoding_matches_jax(g, causal):
    t, d = 4 * g, 24
    want = JP.grouped_relative_encoding(t, d, g, causal=causal)
    got = P.grouped_relative_encoding(t, d, g, causal)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("stride", [1, 2])
def test_causal_strided_depthwise_conv_matches_jax(stride):
    """k - 1 zeros on the left and none on the right, at the stride of a
    causal encoder's strided block."""
    c, k, t = 6, 7, 23
    x = np.random.default_rng(stride).standard_normal((2, t, c)).astype(np.float32)
    jconv = JaxConv1d(c, k, stride=stride, padding="causal", groups=c)
    variables = jconv.init(jax.random.PRNGKey(stride), jnp.asarray(x))
    want = jconv.apply(variables, jnp.asarray(x))
    conv = Conv1d(c, c, k, stride=stride, groups=c, padding="causal")
    with torch.no_grad():
        kernel = np.array(variables["params"]["kernel"])
        conv.weight.copy_(torch.from_numpy(kernel.transpose(2, 1, 0)))
        conv.bias.copy_(torch.from_numpy(np.array(variables["params"]["bias"])))
        got = conv(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LAYER_TOL)


ATTENTION_CASES = {
    # (group size, causal, left, right): the mask is the encoder's
    # streaming mask of ragged lengths 17 / 9 / 3 over T = 17
    "causal-grouped": (3, True, 4, 0),
    "causal-plain": (1, True, 4, 0),
    "limited-grouped": (3, False, 4, 2),
    "limited-plain": (1, False, 4, 2),
}


@pytest.mark.parametrize("case", list(ATTENTION_CASES))
def test_attention_skewing_paths_match_jax(case):
    """The attention under a full (T, T) mask, through the skewing path and
    the bias attention, with query rows that see no valid key (past x_len +
    left_context), and T = 17 padded to 18 at G = 3."""
    g, causal, left, right = ATTENTION_CASES[case]
    d, h, t = 24, 2, 17
    x_len = np.array([17, 9, 3])
    x = np.random.default_rng(30 + g).standard_normal((3, t, d)).astype(np.float32) * 0.5
    mask = np.array(JM.streaming_mask(t, jnp.asarray(x_len), left, right))
    rows = JM.pad_mask_to_multiple(jnp.asarray(mask), g)[:, :, ::g, ::g]
    assert bool((np.asarray(rows) == 1.0).all(-1).any()), "no fully masked row"
    mod = MultiHeadSelfAttention(d, h, causal=causal, group_size=g,
                                 relative_pos_enc=True).eval()
    mod.load_state_dict(port_mhsa(d, h, g, seed=g).state_dict())
    jmod = JaxMHSA(dim_model=d, num_heads=h, group_size=g, causal=causal,
                   relative_pos_enc=True, fused=False)
    want, _ = jmod.apply({"params": jax_mhsa_params(mod)}, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LAYER_TOL)


@pytest.mark.parametrize("which", ["causal", "finite"])
def test_streaming_encoders_match_jax(which, causal_ctc, finite_ctc):
    """The causal encoder (causal convs, causal grouped and plain attention,
    left context 8) and the non-causal limited-context one (left 16, right
    2): logits of a ragged batch, on every valid frame."""
    pair = causal_ctc if which == "causal" else finite_ctc
    audio, x_len = audio_batch(3, 12000, 5000, seed=11)
    want, want_len, _ = pair.jax_encode(jnp.asarray(audio), jnp.asarray(x_len))
    with torch.no_grad():
        got, got_len = pair.port(torch.from_numpy(audio), torch.from_numpy(x_len))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    for i, n in enumerate(np.asarray(want_len)):
        np.testing.assert_allclose(got[i, :n].numpy(), np.asarray(want)[i, :n], rtol=0,
                                   atol=LOGITS_TOL)


def test_causal_variables_load_strictly(causal_ctc, causal_transducer):
    """A causal model has the names of a full-context one: from_jax maps its
    variables and the port loads them with strict=True."""
    for pair in (causal_ctc, causal_transducer):
        sd = from_jax(pair.variables)
        assert set(sd) == set(pair.port.state_dict())


def geometry_configs():
    found = [(path.split("/")[-1], json.load(open(path))["encoder_params"])
             for path in sorted(glob.glob("configs/*.json"))
             if "encoder_params" in json.load(open(path))]
    return found + [("CAUSAL_ENC", CAUSAL_ENC), ("ECF_SHAPED", ECF_SHAPED),
                    ("ECF_SHAPED-finite", FINITE_ENC), ("TINY_ENC", TINY_ENC)]


@pytest.mark.parametrize("name,p", geometry_configs(), ids=[n for n, _ in geometry_configs()])
def test_geometry_matches_jax(name, p):
    """The stride, alignment and receptive fields, and a session's window
    sizes at history 64 and at the default, exactly."""
    for fn in ("_strides_per_stage", "total_stride", "_base_alignment",
               "suggested_lookahead_frames", "suggested_history_frames"):
        assert getattr(S, fn)(p) == getattr(JS, fn)(p), fn
    for history in (64, None):
        want = JS.StreamingEncoderSession(encode_fn=None, encoder_params=p, chunk_frames=16,
                                          history_frames=history, lookahead_frames=4)
        got = S.StreamingEncoderSession(None, p, chunk_frames=16, history_frames=history,
                                        lookahead_frames=4, device="cpu")
        for field in ("history_frames", "chunk_frames", "window_frames", "window_samples",
                      "align"):
            assert getattr(got, field) == getattr(want, field), field
        assert got.geometry.chunk_samples == want.chunk_samples


def test_flagship_geometry():
    """EfficientConformerCTCSmall: stage-1 G = 3 at 4 mel frames an output
    frame aligns window starts to 3, so history 64 and chunk 16 become 66
    and 18, and with lookahead 4 a window is 88 output frames."""
    p = json.load(open("configs/EfficientConformerCTCSmall.json"))["encoder_params"]
    geo = S.WindowGeometry(p, 16, 64, 4)
    assert (geo.align, geo.history_frames, geo.chunk_frames, geo.window_frames) == (3, 66, 18, 88)
    assert geo.window_samples == (88 * 8 - 1) * 160


# ------------------------------------------------------------ greedy stream


def state_arrays(state):
    """The port's state tuple as JAX's dict of numpy arrays."""
    g, (h, c), consec, tokens, n_tok = state
    return {"g": g.numpy(), "carry": (h.numpy(), c.numpy()), "consec": consec.numpy(),
            "tokens": tokens[:, :-1].numpy(), "n_tok": n_tok.numpy()}


@pytest.mark.parametrize("algo", ["label", "frame"])
def test_greedy_decode_stream_matches_jax(algo, causal_transducer):
    """Window by window, with per-row starts and ends: the state after each
    window equals JAX's, and the final tokens equal the whole decode's."""
    pair, max_tokens = causal_transducer, 40
    rng = np.random.default_rng(8)
    f = (rng.standard_normal((3, 23, 24)) * 2.0).astype(np.float32)
    lengths = np.array([23, 17, 5])
    whole = T.decode_frames(pair.port, torch.from_numpy(f), torch.from_numpy(lengths),
                            max_tokens, algo=algo)
    state, jstate = None, None
    for lo, hi in ((0, 4), (4, 11), (11, 11), (11, 23)):
        start, end = np.minimum(lo, lengths), np.minimum(hi, lengths)
        state = T.greedy_decode_stream(pair.port, torch.from_numpy(f), torch.from_numpy(end),
                                       state, f_start=torch.from_numpy(start),
                                       max_tokens=max_tokens, algo=algo)
        jstate = jax_decode_stream(pair.jax, pair.variables, jnp.asarray(f),
                                   jnp.asarray(end, jnp.int32), jstate,
                                   f_start=jnp.asarray(start, jnp.int32),
                                   max_tokens=max_tokens, algo=algo)
        got = state_arrays(state)
        for key in ("tokens", "n_tok", "consec"):
            np.testing.assert_array_equal(got[key], np.asarray(jstate[key]), err_msg=key)
        np.testing.assert_allclose(got["g"], np.asarray(jstate["g"]), rtol=0, atol=LAYER_TOL)
        for mine, theirs in zip(got["carry"], jstate["carry"]):
            np.testing.assert_allclose(mine, np.asarray(theirs), rtol=0, atol=LAYER_TOL)
    assert int(state[4].sum()) > 0
    np.testing.assert_array_equal(state[3][:, :max_tokens].numpy(), whole[0].numpy())
    np.testing.assert_array_equal(state[4].numpy(), whole[1].numpy())


def test_reset_state_rows(causal_transducer):
    """Rows picked by the mask come back to the template, leaf by leaf along
    each leaf's row axis; the others keep their state."""
    model = causal_transducer.port
    template = T.init_state(model, 3, 8, "cpu")
    f = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 6, 24)).astype(np.float32))
    state = T.greedy_decode_stream(model, f * 3, torch.full((3,), 6), None, max_tokens=8)
    reset = T.reset_state_rows(state, template, torch.tensor([False, True, False]))
    for got, old, new in zip(jax.tree.leaves(reset), jax.tree.leaves(state),
                             jax.tree.leaves(template)):
        axis = 1 if got.dim() == 3 else 0
        for row, src in ((0, old), (1, new), (2, old)):
            torch.testing.assert_close(got.select(axis, row), src.select(axis, row),
                                       rtol=0, atol=0)


# ------------------------------------------------------------ sessions


def push_unevenly(push, audio):
    pos = 0
    for n in (5000, 12000, 3000):
        push(audio[:, pos:pos + n])
        pos += n
    push(audio[:, pos:])


@pytest.mark.parametrize("which", ["causal", "finite"])
def test_streamed_frames_equal_the_batch_forward(which, causal_ctc, finite_ctc):
    """The exactness contract of tests/test_streaming_runtime.py:55 (causal)
    and :233 (finite context at the suggested lookahead), on the port:
    streamed logits equal the batch forward on the zero-padded utterance on
    every valid frame, and the emitted frame count is the stream's."""
    pair = causal_ctc if which == "causal" else finite_ctc
    tol = CAUSAL_STREAM_TOL if which == "causal" else FINITE_STREAM_TOL
    look = LOOK if which == "causal" else S.suggested_lookahead_frames(pair.enc)
    chunk = CHUNK if which == "causal" else 6
    audio, x_len = audio_batch(2, 40000, 9000, seed=5)
    sess = S.StreamingEncoderSession(pair.port_encode, pair.enc, batch_size=2,
                                     chunk_frames=chunk, lookahead_frames=look, device="cpu")
    emissions = []
    push_unevenly(lambda a: emissions.extend(sess.push(a)), audio)
    emissions += sess.finish(x_len)
    got = np.concatenate([em.valid for em in emissions], axis=1)
    assert emissions[0].start == 0
    assert got.shape[1] == encoder_output_frames(pair.enc, int(x_len.max()))
    padded = np.concatenate([audio, np.zeros((2, sess.window_samples), np.float32)], axis=1)
    with torch.no_grad():
        want, _ = pair.port(torch.from_numpy(padded), torch.from_numpy(x_len))
    for i in range(2):
        cap = encoder_output_frames(pair.enc, int(x_len[i]))
        np.testing.assert_allclose(got[i, :cap], want[i, :cap].numpy(), rtol=tol, atol=tol)


TAIL_ENC = dict(ECF_SHAPED, left_context=2, right_context=2)


@pytest.fixture(scope="module")
def tail_ctc():
    return Pair("ctc", TAIL_ENC, 7)


def test_finite_context_tail_matches_jax(tail_ctc):
    """Past a row's length plus the left context every query row is fully
    masked and averages V over the whole row, the padding included; the
    non-causal convs carry that into the last valid frames, and a window
    pads otherwise than the batch forward. With left context 2 this reaches
    the last suggested-lookahead frames (with 16, as in the test above, it
    stays below 1e-4): there the JAX package's own streamed frames leave its
    batch forward, and the port's leave the port's by the same amount,
    while every earlier frame agrees. Both sessions' frames and both batch
    forwards are equal between the packages."""
    pair = tail_ctc
    look = S.suggested_lookahead_frames(pair.enc)
    audio, x_len = audio_batch(2, 40000, 9000, seed=5)
    streamed = {}
    for name, sess in (
            ("jax", JS.StreamingEncoderSession(encode_fn=pair.jax_encode,
                                               encoder_params=pair.enc, batch_size=2,
                                               chunk_frames=6, lookahead_frames=look)),
            ("port", S.StreamingEncoderSession(pair.port_encode, pair.enc, batch_size=2,
                                               chunk_frames=6, lookahead_frames=look,
                                               device="cpu"))):
        ems = []
        push_unevenly(lambda a: ems.extend(sess.push(a)), audio)
        ems += sess.finish(x_len)
        streamed[name] = np.concatenate([np.asarray(em.valid) for em in ems], axis=1)
    padded = np.concatenate([audio, np.zeros((2, sess.window_samples), np.float32)], axis=1)
    batch = {"jax": np.asarray(pair.jax_encode(padded, x_len)[0])}
    with torch.no_grad():
        batch["port"] = pair.port(torch.from_numpy(padded), torch.from_numpy(x_len))[0].numpy()
    for i in range(2):
        cap = encoder_output_frames(pair.enc, int(x_len[i]))
        head, tail = slice(0, cap - look), slice(cap - look, cap)
        for name in ("jax", "port"):
            np.testing.assert_allclose(streamed[name][i, head], batch[name][i, head],
                                       rtol=FINITE_STREAM_TOL, atol=FINITE_STREAM_TOL)
            assert np.abs(streamed[name][i, tail] - batch[name][i, tail]).max() > 1e-3
        np.testing.assert_allclose(streamed["port"][i, :cap], streamed["jax"][i, :cap],
                                   rtol=LOGITS_TOL, atol=LOGITS_TOL)
        np.testing.assert_allclose(batch["port"][i, :cap], batch["jax"][i, :cap],
                                   rtol=LOGITS_TOL, atol=LOGITS_TOL)
        np.testing.assert_allclose(streamed["port"][i, tail] - batch["port"][i, tail],
                                   streamed["jax"][i, tail] - batch["jax"][i, tail],
                                   rtol=0, atol=LOGITS_TOL)


def test_streaming_ctc_tokens_match_jax(causal_ctc):
    pair = causal_ctc
    audio, x_len = audio_batch(2, 32000, 5000, seed=0)
    want = JS.StreamingCTC(JS.StreamingEncoderSession(
        encode_fn=pair.jax_encode, encoder_params=pair.enc, batch_size=2, chunk_frames=CHUNK,
        lookahead_frames=LOOK))
    push_unevenly(want.push, audio)
    want_toks = want.finish(x_len)
    got = S.StreamingCTC(S.StreamingEncoderSession(pair.port_encode, pair.enc, batch_size=2,
                                                   chunk_frames=CHUNK, lookahead_frames=LOOK,
                                                   device="cpu"))
    push_unevenly(got.push, audio)
    assert got.finish(x_len) == want_toks
    assert sum(map(len, want_toks)) > 0


def test_streaming_transducer_tokens_match_jax(causal_transducer):
    """The session's windows through the greedy loop: the tokens equal JAX's
    StreamingTransducer and the port's whole-utterance greedy decode."""
    pair, max_tokens = causal_transducer, 64
    audio, x_len = audio_batch(2, 32000, 7000, seed=3)
    want = JS.StreamingTransducer(
        model=pair.jax, variables=pair.variables, max_tokens=max_tokens,
        session=JS.StreamingEncoderSession(encode_fn=pair.jax_encode, encoder_params=pair.enc,
                                           batch_size=2, chunk_frames=CHUNK,
                                           lookahead_frames=LOOK))
    want.push(audio[:, :10000])
    want.push(audio[:, 10000:])
    want_toks, want_n = want.finish(x_len)
    got = S.StreamingTransducer(pair.port, S.StreamingEncoderSession(
        pair.port_encode, pair.enc, batch_size=2, chunk_frames=CHUNK, lookahead_frames=LOOK,
        device="cpu"), max_tokens=max_tokens)
    got.push(audio[:, :10000])
    got.push(audio[:, 10000:])
    toks, n = got.finish(x_len)
    np.testing.assert_array_equal(n, np.asarray(want_n))
    np.testing.assert_array_equal(toks, np.asarray(want_toks))
    assert n.sum() > 0
    whole = T.greedy_decode(pair.port, torch.from_numpy(audio), torch.from_numpy(x_len),
                            max_tokens)
    np.testing.assert_array_equal(n, whole[1].numpy())
    np.testing.assert_array_equal(toks, whole[0].numpy())
