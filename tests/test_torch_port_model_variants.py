"""PyTorch port vs the JAX package: the subsamplings, the encoders built
with each encoder key no shipped config uses, and the decoders, on the CPU
in fp32.

The four subsamplings with their norms, activations and lengths; the
Efficient Conformer built with each encoder key that selects a variant
(att_group_size, att_kernel_size, strided_blocks with att_stride,
relative_pos_enc false, linear_att, subsampling_module), forward and
gradients, and a training step; the Conformer decoder alone and in a
Transducer (lattice, greedy tokens, both beams); variational noise on the
Transformer and Conformer decoders. The JAX modules run unfused, as the JAX
package's own tests run them on the CPU; their variables reach the port
through utils/weights.from_jax, loaded with strict=True. Inputs come from
numpy with fixed seeds.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from efficientconformer_tpu.models.decoders import ConformerDecoder as JaxConformerDecoder
from efficientconformer_tpu.models.decoders import TransformerDecoder as JaxTransformerDecoder
from efficientconformer_tpu.models.model_ctc import ModelCTC as JaxModelCTC
from efficientconformer_tpu.models.modules import SUBSAMPLING as JAX_SUBSAMPLING
from efficientconformer_tpu.models.modules import _max_pool_2d as _jax_max_pool_2d
from efficientconformer_tpu.models.transducer import Transducer as JaxTransducer
from efficientconformer_torch.decoding import rnnt_beam
from efficientconformer_torch.decoding.rnnt_beam_device import beam_search_device
from efficientconformer_torch.models import layers
from efficientconformer_torch.models import transducer as T
from efficientconformer_torch.models.decoders import ConformerDecoder, make_decoder
from efficientconformer_torch.models.model_ctc import ModelCTC
from efficientconformer_torch.models.modules import SUBSAMPLING, MaxPool2d, _max_pool
from efficientconformer_torch.utils import weights as W
from efficientconformer_torch.utils.weights import from_jax
from test_torch_port_model import ragged_audio, valid_frames
from test_torch_port_variants import (
    LOGITS_TOL,
    TOL,
    assert_grads_close,
    jit_apply,
    jit_init,
    perturbed,
    rand,
)
from tests.test_models import TINY_ENC, TINY_JOINT

TRAIN_BN_TOL = 5e-5   # train-mode BatchNorm (see test_subsampling_matches_jax)
VOCAB = 9


# -------------------------------------------------------------- subsampling


@pytest.mark.parametrize("module,norm,act,layers_,t", [
    ("Conv1d", "batch", "swish", 2, 37), ("Conv1d", "layer", "relu", 1, 20),
    ("Conv2d", "layer", "relu", 2, 33), ("Conv2d", "none", "none", 1, 16),
    ("Conv2dPool", "batch", "swish", 2, 37), ("Conv2dPool", "layer", "relu", 1, 18),
    ("VGG", "batch", "relu", 2, 37), ("VGG", "none", "swish", 1, 21),
])
def test_subsampling_matches_jax(module, norm, act, layers_, t):
    """Each subsampling with its norm and activation, and its lengths
    (VGG: l // 2 a stage), flattened as the encoder's input projection
    takes them (the port channel-major, the JAX package mel-major)."""
    mel, filters = 20, [4, 6][:layers_]
    x = rand(2, t, mel, seed=t)
    x_len = np.array([t, t - 7], np.int32)
    jmod = JAX_SUBSAMPLING[module](num_layers=layers_, filters=filters, kernel_size=3,
                                   norm=norm, act=act)
    variables = perturbed(jit_init(jmod, 0, x, x_len, train=False), 1)
    (want, want_len), _ = jmod.apply(variables, jnp.asarray(x), jnp.asarray(x_len), True,
                                     mutable=["batch_stats"])
    want_eval = jmod.apply(variables, jnp.asarray(x), jnp.asarray(x_len), False)[0]
    port = SUBSAMPLING[module](layers_, filters, 3, norm, act, in_dim=mel)
    sd = {}
    W._subsampling(sd, variables["params"], variables.get("batch_stats"))
    port.load_state_dict({k.removeprefix("encoder.subsampling_module."): torch.as_tensor(
        np.array(v)) for k, v in sd.items()}, strict=True)
    if module != "Conv1d":   # (B, T', M' * C) mel-major -> channel-major
        b, tt, mc = want.shape
        c = filters[-1]
        want, want_eval = (np.asarray(w).reshape(b, tt, mc // c, c).transpose(0, 1, 3, 2)
                           .reshape(b, tt, mc) for w in (want, want_eval))
    assert port.out_features(mel) == np.asarray(want).shape[-1]
    for train, w in ((False, want_eval), (True, want)):   # train mode moves the statistics
        port.train(train)
        with torch.no_grad():
            got, got_len = port(torch.from_numpy(x), torch.from_numpy(x_len))
        np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
        # relative too: a layer norm over a few channels of near-equal values
        # scales the convs' rounding up to outputs of order 1. Train-mode
        # BatchNorm: flax's one-pass variance E[x^2] - E[x]^2 against torch's
        # two-pass one, through two layers
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TRAIN_BN_TOL if train else TOL)


@pytest.mark.parametrize("window,stride,pad", [(2, 2, 0), (3, 2, 1)])
def test_max_pool_routes_tied_gradients_as_jax(window, stride, pad):
    """The subsamplings' max-pools (VGG's 2 x 2, Conv2dPool's 3 x 3 with
    -inf padding) on integer mels, whose windows hold tied maxima off their
    first position: the port's gradient equals JAX's reduce_window gradient
    exactly, each window's to its first maximum in time-major order (XLA's
    select_and_scatter). Scanned mel-major, as the (B, C, mel, T) layout
    lies, torch sent it elsewhere."""
    rng = np.random.default_rng(window)
    x = rng.integers(0, 3, (2, 10, 8)).astype(np.float32)       # (B, T, mel), many ties
    def jax_pool(a):
        return _jax_max_pool_2d(a[..., None], (window, window), (stride, stride),
                                ((pad, pad), (pad, pad)))[..., 0]
    want, vjp = jax.vjp(jax_pool, jnp.asarray(x))
    g = rng.standard_normal(want.shape).astype(np.float32)
    want_grad = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).transpose(1, 2)[:, None].requires_grad_()   # (B, 1, mel, T)
    gt = torch.from_numpy(g).transpose(1, 2)[:, None]
    pools = [lambda a: _max_pool(a, window, stride, (pad, pad))]
    if pad == 0:
        pools.append(MaxPool2d(window))     # VGG's layer
    for pool in pools:
        got = pool(xt)
        (grad,) = torch.autograd.grad(got, xt, gt)
        np.testing.assert_array_equal(got.detach()[:, 0].transpose(1, 2).numpy(),
                                      np.asarray(want))
        np.testing.assert_array_equal(grad[:, 0].transpose(1, 2).numpy(), want_grad)


def test_subsampling_rejects_an_unknown_activation():
    with pytest.raises(ValueError, match="unknown activation"):
        SUBSAMPLING["Conv2d"](1, [4], 3, "batch", "gelu")


# ---------------------------------------------------------------- encoders

ENC = dict(TINY_ENC, num_blocks=2, dim_model=16, num_heads=2, kernel_size=5,
           subsampling_filters=[4], n_mels=24)
ENCODER_KEYS = {
    "att_group_size_even": dict(att_group_size=[2, 1], strided_blocks=[0], conv_stride=2,
                                att_stride=1),
    "att_kernel_size": dict(att_kernel_size=4),
    "att_stride": dict(strided_blocks=[0], conv_stride=1, att_stride=2),
    "relative_pos_enc_false": dict(relative_pos_enc=False),
    "linear_att": dict(linear_att=True, relative_pos_enc=False),
    "Conv1d": dict(subsampling_module="Conv1d", subsampling_filters=[24, 16],
                   subsampling_layers=2),
    "Conv2dPool": dict(subsampling_module="Conv2dPool"),
    "VGG": dict(subsampling_module="VGG", subsampling_norm="layer", subsampling_act="relu"),
    "causal_local": dict(att_kernel_size=4, causal=True, left_context=8),
}


def ctc_pair(enc, seed=0):
    jax_model = JaxModelCTC(encoder_params=enc, vocab_size=VOCAB)
    x, x_len = ragged_audio(2, 6000, seed=seed)
    variables = perturbed(jit_init(jax_model, seed, x, x_len), seed + 1)
    port = ModelCTC(enc, VOCAB)
    port.load_state_dict(from_jax(variables), strict=True)
    return jax_model, variables, port.eval(), x, x_len


@pytest.mark.parametrize("key", list(ENCODER_KEYS))
def test_encoder_with_each_key_matches_jax(key):
    """The CTC model built with each encoder key: logits and lengths, then
    the gradients of a fixed linear function of the logits in every
    parameter (eval mode), against jax.grad."""
    enc = dict(ENC, **ENCODER_KEYS[key])
    jax_model, variables, port, x, x_len = ctc_pair(enc)
    logits, got_len = port(torch.from_numpy(x), torch.from_numpy(x_len))
    valid = (np.arange(logits.shape[1])[None] < got_len.numpy()[:, None]).astype(np.float32)
    w = rand(*logits.shape, seed=9) * valid[..., None]

    def loss(params):
        out = jax_model.apply({**variables, "params": params}, jnp.asarray(x), jnp.asarray(x_len))
        return jnp.sum(out[0] * w), out[:2]

    # one compile for the forward and the gradients
    (_, (want, want_len)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    for g_, w_ in zip(valid_frames(logits.detach().numpy(), got_len),
                      valid_frames(np.asarray(want), got_len)):
        np.testing.assert_allclose(g_, w_, rtol=0, atol=LOGITS_TOL)
    want_grads = W.params_from_jax(grads)
    (logits * torch.from_numpy(w)).sum().backward()
    # a parameter the port's path does not reach (the pos bias, which cancels
    # in the factorized softmax) has no gradient: JAX's is zero
    assert_grads_close({n: p.grad if p.grad is not None else torch.zeros_like(p)
                        for n, p in port.named_parameters()},
                       {n: want_grads[n] for n, _ in port.named_parameters()})


def test_even_group_encoder_trains_a_step():
    """A config with even G builds, takes one training step (dropout and
    SpecAugment on, BatchNorm on batch statistics) to a finite loss and
    moves its weights, and decodes."""
    from efficientconformer_torch.models.model_ctc import greedy_decode
    from efficientconformer_torch.ops.ctc_loss import ctc_loss

    enc = dict(ENC, **ENCODER_KEYS["att_group_size_even"], Pdrop=0.1)
    _, _, port, x, x_len = ctc_pair(enc)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    opt = torch.optim.Adam(port.parameters(), 1e-3)
    port.train()
    logits, n = port(torch.from_numpy(x), torch.from_numpy(x_len), torch.Generator())
    labels = torch.tensor([[1, 2, 3], [4, 5, 0]])
    loss = ctc_loss(torch.log_softmax(logits, -1), labels, n, torch.tensor([3, 2])).mean()
    loss.backward()
    opt.step()
    assert torch.isfinite(loss)
    assert all(not torch.equal(p, before[name]) for name, p in port.named_parameters()
               if p.grad is not None)
    tokens, counts = greedy_decode(port.eval(), torch.from_numpy(x), torch.from_numpy(x_len))
    assert tokens.shape[0] == 2 and counts.shape == (2,)


# ---------------------------------------------------------------- decoders

CONF_DEC = {"arch": "Conformer", "num_blocks": 2, "dim_model": 12, "ff_ratio": 2,
            "num_heads": 2, "kernel_size": 3, "Pdrop": 0.0, "relative_pos_enc": True,
            "max_pos_encoding": 64, "vocab_size": VOCAB}
TRANS_DEC = {"arch": "Transformer", "num_blocks": 2, "dim_model": 12, "ff_ratio": 2,
             "num_heads": 2, "Pdrop": 0.0, "relative_pos_enc": True, "max_pos_encoding": 64,
             "vocab_size": VOCAB}


def decoder_state(variables) -> dict:
    sd = from_jax({"params": {"decoder": variables["params"]},
                   "batch_stats": {"decoder": variables.get("batch_stats", {})}})
    return {k.removeprefix("decoder."): v for k, v in sd.items()}


@pytest.mark.parametrize("rel,left", [(True, None), (False, None), (True, 2)])
def test_conformer_decoder_matches_jax(rel, left):
    """The causal Conformer decoder over a padded label batch (rel-pos, and
    the absolute encoding without; a left context of 2 tokens), and its
    fp32 step on its caches against its own forward."""
    params = dict(CONF_DEC, relative_pos_enc=rel)
    if left is not None:
        params["left_context"] = left
    y = np.array([[0, 3, 1, 4, 2, 5], [0, 2, 2, 0, 0, 0]], np.int32)
    y_len = np.array([6, 3], np.int32)
    jmod = JaxConformerDecoder(params=params)
    variables = perturbed(jit_init(jmod, 3, y, y_len), 4)
    want = jit_apply(jmod, variables, y, y_len)
    port = ConformerDecoder(params)
    port.load_state_dict(decoder_state(variables), strict=True)
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(y).long(), torch.from_numpy(y_len).long())
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want)[0], rtol=0, atol=LOGITS_TOL)
        np.testing.assert_allclose(got[1, :3].numpy(), np.asarray(want)[1, :3], rtol=0,
                                   atol=LOGITS_TOL)
        carry = port.init_carry(2, "cpu", 8)
        for u in range(6):
            g, carry = port.step(torch.from_numpy(y[:, u]).long(), carry)
            np.testing.assert_allclose(g[0].numpy(), got[0, u].numpy(), rtol=0, atol=TOL)
            if u < 3:
                np.testing.assert_allclose(g[1].numpy(), got[1, u].numpy(), rtol=0, atol=TOL)
    assert carry[3][0, :, 0].tolist() == [6, 6]


def conformer_transducer(seed=5):
    enc = dict(TINY_ENC, num_blocks=1, subsampling_filters=[4], n_mels=24, dim_model=12)
    jax_model = JaxTransducer(encoder_params=enc, decoder_params=CONF_DEC,
                              joint_params=TINY_JOINT, vocab_size=VOCAB)
    x, x_len = ragged_audio(2, 4000, seed=seed)
    y = np.array([[1, 2, 3], [4, 5, 0]], np.int32)
    y_len = np.array([3, 2], np.int32)
    variables = perturbed(jit_init(jax_model, seed, x, y, x_len, y_len), seed + 1)
    # lean on the blank, so that the hypotheses stay short of the token cap
    joint = variables["params"]["joint_network"]["linear_joint"]
    joint["bias"] = joint["bias"].at[0].add(0.25)
    port = T.Transducer(enc, CONF_DEC, TINY_JOINT, VOCAB)
    port.load_state_dict(from_jax(variables), strict=True)
    return jax_model, variables, port.eval(), x, x_len, y, y_len


def test_conformer_decoder_transducer_matches_jax():
    """A Transducer with the Conformer decoder: the lattice against the JAX
    package's; greedy decoding against the per-utterance state machine of
    the reference (tests/test_models.py) run on the JAX package's encoder,
    joint and decoder (the JAX decoder recomputed over each history: the
    JAX package has no step of its own); both beams
    return token lists of the same best hypothesis."""
    jax_model, variables, port, x, x_len, y, y_len = conformer_transducer()
    want, want_len = jax.jit(lambda v, *a: jax_model.apply(v, *a, False))(
        variables, *map(jnp.asarray, (x, y, x_len, y_len)))
    with torch.no_grad():
        got, got_len = port(torch.from_numpy(x), torch.from_numpy(y).long(),
                            torch.from_numpy(x_len), torch.from_numpy(y_len).long())
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)

    f, f_len, _ = jax.jit(lambda v, a, n: jax_model.apply(v, a, n, False,
                                                          method=JaxTransducer.encode))(
        variables, jnp.asarray(x), jnp.asarray(x_len))
    dec = JaxConformerDecoder(params=CONF_DEC)
    dvars = {k: v["decoder"] for k, v in variables.items() if "decoder" in v}

    cap = 24
    dec_fn = jax.jit(lambda h, n: dec.apply(dvars, h, n))

    def g_of(history):    # one shape, so one compile: the history padded to cap + 1
        h = np.zeros((1, cap + 1), np.int32)
        h[0, :len(history)] = history
        return dec_fn(jnp.asarray(h), jnp.asarray([len(history)]))[0, len(history) - 1]

    joint = jax.jit(lambda f_t, g_t: jax_model.apply(variables, f_t[None], g_t[None],
                                                     method=JaxTransducer.joint_step)[0])

    tokens, counts = T.greedy_decode(port, torch.from_numpy(x), torch.from_numpy(x_len), cap)
    emitted = []
    for b in range(2):
        hist, t, consec = [0], 0, 0
        g = g_of(hist)
        while t < int(f_len[b]) and len(hist) - 1 < cap:
            pred = int(jnp.argmax(joint(f[b, t], g)))
            if pred == 0 or consec >= 5:
                t, consec = t + 1, 0
            else:
                hist.append(pred)
                consec += 1
                g = g_of(hist)
        assert tokens[b, :int(counts[b])].tolist() == hist[1:]
        assert len(hist) - 1 < cap
        emitted.append(len(hist) - 1)
    assert sum(emitted) > 0
    dev_tokens = beam_search_device(port, torch.from_numpy(x), torch.from_numpy(x_len),
                                    beam_size=3, max_tokens=64)
    host_tokens = rnnt_beam.beam_search(port, torch.from_numpy(x), torch.from_numpy(x_len),
                                        beam_size=3)
    assert dev_tokens == host_tokens


@pytest.mark.parametrize("arch", ["Transformer", "Conformer"])
def test_decoder_variational_noise_matches_jax(arch):
    """With vn_std the Transformer and Conformer decoders' blocks carry the
    same noise as the JAX decoder's Dense and Conv1d kernels: the port's
    draw, added to the JAX weights, gives the JAX output (the embedding
    takes none)."""
    vn_std = 0.3
    params = dict(CONF_DEC if arch == "Conformer" else TRANS_DEC)
    y = np.array([[0, 3, 1, 4], [0, 2, 2, 0]], np.int32)
    y_len = np.array([4, 3], np.int32)
    jcls = JaxConformerDecoder if arch == "Conformer" else JaxTransformerDecoder
    variables = perturbed(jit_init(jcls(params=params), 6, y, y_len), 7)
    port = make_decoder(params, vn_std)
    port.load_state_dict(decoder_state(variables), strict=True)
    port.eval()
    layers.draw_variational_noise_(port, torch.Generator().manual_seed(9))
    noised = {}
    for name, m in port.named_modules():
        if isinstance(m, layers.VariationalNoise) and m.vn_noise is not None:
            for w, n in m.vn_noise.items():
                noised[f"{name}.{w}"] = n
    assert noised and not any(k.startswith("embedding") for k in noised)
    sd = {k: v + vn_std * noised[k] if k in noised else v for k, v in port.state_dict().items()}
    plain = make_decoder(params)
    plain.load_state_dict(sd, strict=True)
    jvars = {"params": jax.tree.map(
        jnp.asarray, _decoder_params(plain, variables["params"], W)),
        **({"batch_stats": variables["batch_stats"]} if "batch_stats" in variables else {})}
    want = jit_apply(jcls(params=params), jvars, y, y_len)
    with torch.no_grad():
        got = port(torch.from_numpy(y).long(), torch.from_numpy(y_len).long())
    layers.clear_variational_noise_(port)
    valid = [(0, 4), (1, 3)]
    for b, n in valid:
        np.testing.assert_allclose(got[b, :n].numpy(), np.asarray(want)[b, :n], rtol=0,
                                   atol=LOGITS_TOL)


def _decoder_params(module, template, weights):
    """The JAX params tree ``template`` with the noised port weights of
    ``module`` written into it (by matching from_jax's names)."""
    sd = {k: v.numpy() for k, v in module.state_dict().items()}
    leaves = jax.tree_util.tree_flatten_with_path(template)[0]
    out = jax.tree.map(np.asarray, template)
    for path, leaf in leaves:
        probe = jax.tree.map(np.zeros_like, template)
        node = probe
        for p in path[:-1]:
            node = node[p.key]
        node[path[-1].key] = np.ones_like(np.asarray(leaf))
        mapped = weights.from_jax({"params": {"decoder": probe}})
        hit = [k for k, v in mapped.items() if v.abs().sum() > 0]
        assert len(hit) == 1, (path, hit)
        key = hit[0].removeprefix("decoder.")
        val = sd[key]
        if val.ndim == 2 and "embedding" not in key:
            val = val.T
        elif val.ndim == 3:
            val = val[:, :, 0].T if val.shape[-1] == 1 else val.transpose(2, 1, 0)
        node2 = out
        for p in path[:-1]:
            node2 = node2[p.key]
        node2[path[-1].key] = np.asarray(val).reshape(np.asarray(leaf).shape)
    return out


def test_absolute_transformer_decoder_matches_jax_and_steps():
    """A Transformer decoder without rel-pos encodings (the absolute
    encoding added to its input): the teacher-forced pass against the JAX
    package's, and both of the port's steps (the growing cache and the
    fixed-capacity cache, the encoding of each row's position added)
    against that pass."""
    params = dict(TRANS_DEC, relative_pos_enc=False)
    y = np.array([[0, 3, 1, 4, 2], [0, 2, 2, 5, 1]], np.int32)
    y_len = np.array([5, 5], np.int32)
    jmod = JaxTransformerDecoder(params=params)
    variables = jit_init(jmod, 8, y, y_len)
    want = jit_apply(jmod, variables, y, y_len)
    port = make_decoder(params)
    port.load_state_dict(decoder_state(variables), strict=True)
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(y).long(), torch.from_numpy(y_len).long())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGITS_TOL)
        growing, fixed = None, port.init_carry_fixed(2, 8, "cpu")
        for u in range(5):
            tok = torch.from_numpy(y[:, u]).long()
            g1, growing = port.step(tok, growing)
            g2, fixed = port.step(tok, fixed)
            np.testing.assert_allclose(g1.numpy(), got[:, u].numpy(), rtol=0, atol=TOL)
            np.testing.assert_allclose(g2.numpy(), got[:, u].numpy(), rtol=0, atol=TOL)
