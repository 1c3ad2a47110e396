"""PyTorch port vs the JAX package: the attention variants, on the CPU in
fp32.

Every rel_to_abs skewing and the other attention helpers; every branch of
the attention module (rel-pos with an even group size, local, strided and
strided local, absolute plain, grouped, local, strided and strided local,
linear) under a key mask and under a full window mask, forward and
gradients, and the grouped and strided KV caches. The JAX modules run
unfused (``fused=False``), as the JAX package's own tests run them on the
CPU; their parameters are loaded into the port's modules. Inputs come from
numpy with fixed seeds. tests/test_torch_port_model_variants.py holds the
subsamplings, the encoders built with each key and the decoders.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from efficientconformer_tpu.models.attentions import MultiHeadSelfAttention as JaxMHSA
from efficientconformer_tpu.ops import attention as JA
from efficientconformer_tpu.ops import masks as JM
from efficientconformer_tpu.ops import pos_enc as JP
from efficientconformer_torch.models.attentions import MultiHeadSelfAttention
from efficientconformer_torch.models.modules import MultiHeadSelfAttentionModule
from efficientconformer_torch.ops import attention as A
from efficientconformer_torch.ops import masks as M
from efficientconformer_torch.ops import pos_enc as P

TOL = 1e-5            # one layer or helper, fp32, summation order only
LOGITS_TOL = 1e-4     # the bound of tests/test_torch_parity.py, after every block
GRAD_TOL = 1e-4       # gradients, relative to max(max|g|, 1)
D, H = 16, 2


def rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def jit_apply(module, variables, *args, **kwargs):
    return jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))(
        variables, *map(jnp.asarray, args))


def jit_init(module, seed, *args, **kwargs):
    """Variables shaped as ``module.init``'s, drawn with numpy without
    compiling the init (which takes seconds on the CPU, eager or jitted):
    kernels N(0, 1/(3 fan_in)), the variance of the torch-default uniform
    init, embeddings N(0, 1), other parameters N(0, 0.1^2),
    norm scales 1 and BatchNorm statistics (0, 1), which ``perturbed``
    moves; static arguments (a train flag) go in ``kwargs``."""
    shapes = jax.eval_shape(lambda key, *a: module.init(key, *a, **kwargs),
                            jax.random.PRNGKey(seed), *map(jnp.asarray, args))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("scale", "var"):
            return jnp.ones(leaf.shape, leaf.dtype)
        if name == "mean":
            return jnp.zeros(leaf.shape, leaf.dtype)
        std = (1.0 / np.sqrt(3 * np.prod(leaf.shape[:-1])) if name == "kernel"
               else 1.0 if name == "embedding" else 0.1)
        return jnp.asarray(rng.standard_normal(leaf.shape) * std, leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def perturbed(variables, seed):
    """JAX variables with their norm scales and biases and BatchNorm
    statistics moved off their init, so that eval-mode norms are exercised."""
    rng = np.random.default_rng(seed)

    def move(path, x):
        name = path[-1].key
        x = np.asarray(x)
        if name == "scale":
            return jnp.asarray(1.0 + 0.1 * rng.standard_normal(x.shape), jnp.float32)
        if name == "mean":
            return jnp.asarray(0.2 * rng.standard_normal(x.shape), jnp.float32)
        if name == "var":
            return jnp.asarray(0.5 + rng.random(x.shape), jnp.float32)
        return jnp.asarray(x)

    return jax.tree_util.tree_map_with_path(move, variables)


def mhsa_state(params) -> dict:
    """A JAX MultiHeadSelfAttention's params -> the port module's state."""
    sd = {}
    for name in ("query", "key", "value", "output", "pos"):
        if name in params:
            sd[f"{name}_layer.weight"] = torch.tensor(np.asarray(params[name]["kernel"]).T.copy())
            sd[f"{name}_layer.bias"] = torch.tensor(np.asarray(params[name]["bias"]))
    for name in ("u", "v"):
        if name in params:
            sd[name] = torch.tensor(np.asarray(params[name]))
    return sd


def assert_grads_close(got: dict, want: dict, tol=GRAD_TOL):
    assert got.keys() == want.keys()
    for name in got:
        size = max(want[name].abs().max().item(), 1.0)
        err = (got[name] - want[name]).abs().max().item()
        assert err <= tol * size, f"{name}: |diff| {err} > {tol * size}"


# ------------------------------------------------------------------- helpers


@pytest.mark.parametrize("fn,shape,args", [
    ("rel_to_abs_full", (2, 3, 5, 9), ()), ("rel_to_abs_full", (2, 3, 4, 13), ()),
    ("rel_to_abs_causal", (2, 3, 5, 5), ()), ("rel_to_abs_causal", (2, 3, 4, 10), ()),
    ("rel_to_abs_strided_full", (2, 3, 4, 15), (2,)),
    ("rel_to_abs_strided_full", (2, 3, 3, 17), (3,)),
    ("rel_to_abs_strided_full", (2, 3, 5, 23), (2,)),
    ("rel_to_abs_strided_causal", (2, 3, 4, 8), (2,)),
    ("rel_to_abs_strided_causal", (2, 3, 3, 9), (3,)),
    ("rel_to_abs_strided_causal", (2, 3, 5, 14), (2,)),
    ("rel_to_abs_local_full", (2, 3, 8, 7), (4,)), ("rel_to_abs_local_full", (2, 3, 15, 9), (5,)),
    ("rel_to_abs_local_full", (2, 3, 3, 5), (3,)),
    ("rel_to_abs_local_causal", (2, 3, 8, 4), (4,)),
    ("rel_to_abs_local_causal", (2, 3, 15, 5), (5,)),
    ("rel_to_abs_local_causal", (2, 3, 3, 3), (3,)),
    ("rel_to_abs_strided_local_full", (2, 3, 4, 7), (4, 2)),
    ("rel_to_abs_strided_local_full", (2, 3, 4, 11), (6, 3)),
    ("rel_to_abs_strided_local_full", (2, 3, 3, 7), (4, 4)),
    ("rel_to_abs_strided_local_causal", (2, 3, 4, 4), (4, 2)),
    ("rel_to_abs_strided_local_causal", (2, 3, 4, 6), (6, 3)),
    ("rel_to_abs_strided_local_causal", (2, 3, 3, 4), (4, 4)),
])
def test_rel_to_abs_matches_jax(fn, shape, args):
    """Every skewing of tests/test_rel_to_abs.py, case for case (its T, Th,
    S, K and block counts), on the same scores."""
    scores = rand(*shape, seed=sum(shape))
    want = np.asarray(getattr(JA, fn)(jnp.asarray(scores), *args))
    got = getattr(A, fn)(torch.from_numpy(scores), *args)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("t,g,th,causal", [(6, 2, 0, False), (8, 4, 0, True), (6, 3, 3, False),
                                           (6, 3, 3, True), (4, 2, 6, False)])
def test_grouped_relative_encoding_with_history_matches_jax(t, g, th, causal):
    want = JP.grouped_relative_encoding(t, 16, g, hidden_len=th, causal=causal)
    got = P.grouped_relative_encoding(t, 16, g, causal, hidden_len=th)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_masks_encodings_and_softmax_match_jax():
    np.testing.assert_allclose(P.absolute_encoding(11, 16).numpy(),
                               np.asarray(JP.absolute_encoding(11, 16)), rtol=0, atol=TOL)
    x_len = np.array([12, 7])
    for mask in (JM.streaming_mask(12, jnp.asarray(x_len), 5, 2),
                 JM.padding_mask(12, jnp.asarray(x_len))):
        mask = np.asarray(mask)
        np.testing.assert_array_equal(M.local_block_diagonal(torch.from_numpy(mask), 4).numpy(),
                                      np.asarray(JM.local_block_diagonal(jnp.asarray(mask), 4)))
    for mask in (None, np.asarray(JM.padding_mask(10, jnp.asarray([10, 6])))):
        want = JM.pad_mask_to_multiple(mask, 4) if mask is not None else None
        got = M.ensure_kv_mask(torch.from_numpy(mask) if mask is not None else None, 10, 4)
        if mask is None:
            np.testing.assert_array_equal(got.numpy()[0, 0, 0], [0.0] * 10 + [1.0] * 2)
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    scores, v, mask = rand(2, 3, 5, 7, seed=1), rand(2, 3, 7, 4, seed=2), np.zeros((2, 1, 1, 7))
    mask[1, ..., 5:] = 1.0
    want, _ = JA.softmax_attention(jnp.asarray(scores), jnp.asarray(v),
                                   jnp.asarray(mask, jnp.float32))
    got, _ = A.softmax_attention(torch.from_numpy(scores + mask * A.NEG_INF).float(),
                                 torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


# ---------------------------------------------------------------- attention

VARIANTS = {
    "rel-even-g2": dict(relative_pos_enc=True, group_size=2),
    "rel-even-g4": dict(relative_pos_enc=True, group_size=4),
    "rel-even-g2-causal": dict(relative_pos_enc=True, group_size=2, causal=True),
    "rel-local": dict(relative_pos_enc=True, kernel_size=4),
    "rel-local-causal": dict(relative_pos_enc=True, kernel_size=4, causal=True),
    "rel-strided": dict(relative_pos_enc=True, stride=2),
    "rel-strided-causal": dict(relative_pos_enc=True, stride=3, causal=True),
    "rel-strided-local": dict(relative_pos_enc=True, kernel_size=6, stride=2),
    "rel-strided-local-causal": dict(relative_pos_enc=True, kernel_size=6, stride=2, causal=True),
    "abs": dict(),
    "abs-grouped": dict(group_size=3),
    "abs-grouped-even": dict(group_size=2),
    "abs-local": dict(kernel_size=4),
    "abs-strided": dict(stride=3),
    "abs-strided-local": dict(kernel_size=6, stride=2),
    "linear": dict(linear_att=True),
}


def attention_case(kind, mask_kind, t=13, b=2, seed=0):
    x = rand(b, t, D, seed=seed, scale=0.5)
    x_len = np.array([t, t - 4][:b])
    if mask_kind == "key":
        mask = np.asarray(JM.padding_mask(t, jnp.asarray(x_len)))
    else:
        mask = np.asarray(JM.streaming_mask(t, jnp.asarray(x_len), 5, 3))
    kwargs = VARIANTS[kind]
    jmod = JaxMHSA(dim_model=D, num_heads=H, fused=False, **kwargs)
    variables = jit_init(jmod, seed + 1, x, mask)
    port = MultiHeadSelfAttention(D, H, **kwargs)
    port.load_state_dict(mhsa_state(variables["params"]), strict=True)
    return jmod, variables, port, x, mask


@pytest.mark.parametrize("kind,mask_kind", [
    (kind, mask_kind) for kind in VARIANTS for mask_kind in ("key", "window")
    if mask_kind == "window" or not VARIANTS[kind].get("causal")])
def test_attention_variant_matches_jax(kind, mask_kind):
    """Each branch of the attention module the port had not, under a key
    mask and under a (T, T) window mask (causal layers only under the
    window mask, from which they take their causality, as the encoders and
    decoders give it), forward and the gradients in x."""
    jmod, variables, port, x, mask = attention_case(kind, mask_kind)
    want, _ = jmod.apply(variables, jnp.asarray(x), jnp.asarray(mask))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = port(xt, torch.from_numpy(mask))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=TOL)
    w = rand(*want.shape, seed=5)
    want_dx = jax.jit(jax.grad(lambda x_: jnp.sum(
        jmod.apply(variables, x_, jnp.asarray(mask))[0] * w)))(jnp.asarray(x))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), rtol=0, atol=GRAD_TOL)


@pytest.mark.parametrize("kwargs,match", [
    (dict(group_size=2, kernel_size=4), "Local grouped"),
    (dict(group_size=3, stride=2), "Strided grouped"),
    (dict(linear_att=True, relative_pos_enc=True), "Linear attention"),
])
def test_invalid_attention_combinations_raise(kwargs, match):
    """The JAX module's asserts (modules.py:286-297), as ValueError."""
    with pytest.raises(ValueError, match=match):
        MultiHeadSelfAttentionModule(D, H, 0.0, **kwargs)


@pytest.mark.parametrize("group,chunk", [(1, 1), (3, 3), (2, 2)])
def test_grouped_kv_cache_matches_jax(group, chunk):
    """tests/test_attention.py::test_causal_streaming_kv_cache: chunked
    causal decoding on the KV cache (a grouped layer attends the cache from
    Th % G on) equals the full causal pass under the look-ahead mask, and
    the JAX package's chunks."""
    t = 6
    x = rand(1, t, D, seed=3, scale=0.5)
    jmod = JaxMHSA(dim_model=D, num_heads=H, relative_pos_enc=True, causal=True,
                   group_size=group, fused=False)
    variables = jit_init(jmod, 2, x[:, :chunk])
    port = MultiHeadSelfAttention(D, H, causal=True, group_size=group, relative_pos_enc=True)
    port.load_state_dict(mhsa_state(variables["params"]), strict=True)
    la = JM.streaming_mask(t, None, t, 0)
    full, _ = jmod.apply(variables, jnp.asarray(x), la)
    chunk_apply = jax.jit(lambda v, xc, h: jmod.apply(v, xc, None, h))   # a compile a cache length
    outs, hidden, want_outs, jhidden = [], None, [], None
    with torch.no_grad():
        for i in range(0, t, chunk):
            o, hidden = port.forward_cached(torch.from_numpy(x[:, i:i + chunk]), None, hidden)
            outs.append(o.numpy())
            wo, jhidden = chunk_apply(variables, jnp.asarray(x[:, i:i + chunk]), jhidden)
            want_outs.append(np.asarray(wo))
        got = np.concatenate(outs, axis=1)
        assert hidden["k"].shape == (1, t, D)
        whole = port(torch.from_numpy(x), torch.from_numpy(np.asarray(la)))
    np.testing.assert_allclose(got, np.concatenate(want_outs, axis=1), rtol=0, atol=TOL)
    np.testing.assert_allclose(whole.numpy(), np.asarray(full), rtol=0, atol=TOL)
    if group == chunk:   # streaming-consistent at group-aligned chunks
        np.testing.assert_allclose(got, np.asarray(full), rtol=0, atol=2e-5)


def test_strided_kv_cache_matches_jax():
    """A strided rel-pos layer on a growing cache, as the JAX module."""
    x = rand(1, 8, D, seed=4, scale=0.5)
    jmod = JaxMHSA(dim_model=D, num_heads=H, relative_pos_enc=True, causal=True, stride=2,
                   fused=False)
    variables = jit_init(jmod, 3, x[:, :4])
    port = MultiHeadSelfAttention(D, H, causal=True, stride=2, relative_pos_enc=True)
    port.load_state_dict(mhsa_state(variables["params"]), strict=True)
    wo1, jh = jmod.apply(variables, jnp.asarray(x[:, :4]), None, None)
    wo2, _ = jmod.apply(variables, jnp.asarray(x[:, 4:]), None, jh)
    with torch.no_grad():
        o1, h = port.forward_cached(torch.from_numpy(x[:, :4]), None, None)
        o2, _ = port.forward_cached(torch.from_numpy(x[:, 4:]), None, h)
    np.testing.assert_allclose(o1.numpy(), np.asarray(wo1), rtol=0, atol=TOL)
    np.testing.assert_allclose(o2.numpy(), np.asarray(wo2), rtol=0, atol=TOL)
