"""PyTorch port vs the JAX package: the fused factorized rel-pos attention
(ops/rel_attention.py) and the attention module's factorized branches.

On the CPU the port's wrapper runs its plain PyTorch version; it is held to
the JAX reference and to the Pallas kernel in interpret mode, as
tests/test_pallas_rel_attention.py runs it. The CUDA kernel itself is held to
the plain version on the card (tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import functools
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

import efficientconformer_tpu.ops.pallas_rel_attention as PRA
import efficientconformer_tpu.ops.rel_factorize as JRF
from efficientconformer_tpu.models.attentions import MultiHeadSelfAttention as JaxMHSA
from efficientconformer_torch.models.attentions import MultiHeadSelfAttention
from efficientconformer_torch.ops import rel_attention as RA

TOL = 1e-5          # fp32, same algorithm, summation order only
MODULE_TOL = 2e-5   # the bound of tests/test_pallas_rel_attention.py


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def inputs(layout, b=2, h=2, n=13, d=24, bias_b=2, hdp=None, seed=0):
    """numpy (qu, k, v, delta, w, rowtab, keytab, bias, scale) in the layout
    the attention module builds: plain, or grouped with G = 3."""
    g = 3 if layout == "grouped" else 1
    dh = g * d // h
    hdp = d // 2 if hdp is None else hdp
    pos_kernel = rand(d, d, seed=seed + 4, scale=0.3)
    if g > 1:
        w = JRF.rel_w_grouped(h, dh, jnp.asarray(pos_kernel), g, hdp, 0)
        delta = np.tile(rand(d, seed=seed + 1, scale=0.5), g).reshape(h, dh)
    else:
        w = JRF.rel_w_plain(jnp.asarray(pos_kernel), h, hdp)
        delta = rand(h, dh, seed=seed + 1, scale=0.5)
    lengths = np.linspace(n // 2, n, bias_b).astype(int)
    bias = np.where(np.arange(n)[None, :] >= lengths[:, None], -1e9, 0.0)
    return (rand(b, h, n, dh, seed=seed), rand(b, h, n, dh, seed=seed + 2),
            rand(b, h, n, dh, seed=seed + 3), delta, np.asarray(w),
            np.asarray(JRF.rel_rowtab(n, d, hdp, jnp.float32, stride=g)),
            np.asarray(JRF.rel_keytab_halves(n, d, hdp, jnp.float32, stride=g)),
            bias.astype(np.float32)[:, None, None, :], 1.0 / math.sqrt(dh))


def to_torch(args):
    return [torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) else a for a in args]


def to_jax(args):
    return [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]


@pytest.mark.parametrize("layout", ["plain", "grouped"])
@pytest.mark.parametrize("n,bias_b", [(13, 2), (19, 1), (16, 2)])
def test_plain_version_matches_jax_reference(layout, n, bias_b):
    args = inputs(layout, n=n, bias_b=bias_b, seed=n)
    want = PRA.reference_relpos_attention(*to_jax(args))
    got, lse = RA.reference_relpos_attention(*to_torch(args))
    assert lse.shape == got.shape[:3] and lse.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("layout", ["plain", "grouped"])
@pytest.mark.parametrize("n", [11, 21])
def test_wrapper_on_cpu_matches_pallas_interpret(interpret_mode, layout, n):
    """o and the row log-sum-exp of the port (on the CPU) vs the Pallas
    kernel; the JAX kernel needs its lane-padded half width, which the port
    takes as any other width."""
    args = inputs(layout, b=2, h=2, n=n, d=16, hdp=PRA.lane_half(16), seed=3 * n)
    want_o, want_lse = PRA._forward(*to_jax(args))
    RA.relpos_attention.launches = 0
    got_o, got_lse = RA.relpos_attention(*to_torch(args))
    assert RA.relpos_attention.launches == 0   # CPU tensors: the plain version
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=0, atol=TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse)[:, :, :n, 0],
                               rtol=0, atol=TOL)


def test_wrapper_keeps_the_input_dtype_and_handles_no_bias():
    args = to_torch(inputs("plain", n=9, seed=5))
    o, lse = RA.relpos_attention(*args[:7], None, args[8])
    want, _ = RA.reference_relpos_attention(*args[:7], None, args[8])
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    torch.testing.assert_close(o, want, rtol=0, atol=0)
    o16, _ = RA.relpos_attention(*[a.to(torch.bfloat16) for a in args[:3]], *args[3:])
    assert o16.dtype == torch.bfloat16


def port_mhsa(d, h, g, seed):
    mod = MultiHeadSelfAttention(d, h, group_size=g, relative_pos_enc=True).eval()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    return mod


def jax_mhsa_params(mod):
    params = {name: {"kernel": getattr(mod, f"{name}_layer").weight.detach().numpy().T,
                     "bias": getattr(mod, f"{name}_layer").bias.detach().numpy()}
              for name in ("query", "key", "value", "output", "pos")}
    params["u"] = mod.u.detach().numpy()
    params["v"] = mod.v.detach().numpy()
    return jax.tree.map(jnp.asarray, params)


@pytest.mark.parametrize("g,n", [(1, 21), (3, 33), (3, 31)])
def test_attention_module_matches_jax(g, n):
    d, h = 24, 2
    x = rand(2, n, d, seed=40, scale=0.5)
    mask = np.zeros((2, 1, 1, n), np.float32)
    mask[1, :, :, n - 5:] = 1.0
    mod = port_mhsa(d, h, g, seed=g)
    want, _ = JaxMHSA(dim_model=d, num_heads=h, group_size=g, relative_pos_enc=True,
                      fused=False).apply({"params": jax_mhsa_params(mod)}, jnp.asarray(x),
                                         jnp.asarray(mask))
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=MODULE_TOL)


def port_module(d, h, seed, **kwargs):
    """An attention module of any variant with weights drawn from ``seed``,
    and its params for the JAX module."""
    mod = MultiHeadSelfAttention(d, h, **kwargs).eval()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    params = {name: {"kernel": getattr(mod, f"{name}_layer").weight.detach().numpy().T,
                     "bias": getattr(mod, f"{name}_layer").bias.detach().numpy()}
              for name in ("query", "key", "value", "output", "pos")
              if hasattr(mod, f"{name}_layer")}
    if mod.relative_pos_enc:
        params.update(u=mod.u.detach().numpy(), v=mod.v.detach().numpy())
    return mod, jax.tree.map(jnp.asarray, params)


@pytest.mark.parametrize("kwargs", [dict(relative_pos_enc=False), dict(causal=True, group_size=2),
                                    dict(group_size=2), dict(kernel_size=4),
                                    dict(stride=2), dict(linear_att=True)])
def test_attention_variants_match_jax(kwargs):
    """The variants this file once held to a refusal (absolute attention,
    even G causal and not, local, strided, linear) now match the JAX module
    under a window + padding mask; tests/test_torch_port_variants.py holds
    each branch in more cases."""
    kwargs = {"relative_pos_enc": not kwargs.get("linear_att", False), **kwargs}
    d, h, n = 16, 2, 14
    x = rand(2, n, d, seed=41, scale=0.5)
    mask = np.maximum((np.arange(n)[None, :] > np.arange(n)[:, None] + (
        0 if kwargs.get("causal") else 3)).astype(np.float32),
        (np.arange(n) >= np.array([[n], [n - 5]])).astype(np.float32)[:, None, :])[:, None]
    mod, params = port_module(d, h, seed=7, **kwargs)
    want, _ = JaxMHSA(dim_model=d, num_heads=h, fused=False, **kwargs).apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=MODULE_TOL)


def test_full_attention_mask_at_width_135():
    """A full (T, T) mask takes the skewing path to the bias attention,
    whose kernels take every head width: EfficientConformer Medium/Large's
    stage 1 (3 x 180 / 4 = 135) is not refused before the card
    (tests/test_torch_port_cuda.py runs it there), on the kernels that hold
    a row whole in both types, and on the CPU its plain version matches the
    JAX module."""
    from efficientconformer_torch.ops import bias_attention as BA

    dh = 3 * 180 // 4
    for dtype, name in ((torch.float32, "fma"), (torch.bfloat16, "tc")):
        assert BA.route(dtype, 7, 7, dh, dh).name == name
    mod, params = port_module(180, 4, seed=8, group_size=3, relative_pos_enc=True)
    x = rand(1, 7, 180, seed=9, scale=0.5)
    mask = (np.arange(7)[None, :] > np.arange(7)[:, None]).astype(np.float32)[None, None]
    want, _ = JaxMHSA(dim_model=180, num_heads=4, group_size=3, relative_pos_enc=True,
                      fused=False).apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=MODULE_TOL)


# ------------------------------------------------------------------ backward

def fold_dbias(dbias_hb, bias_b):
    db = dbias_hb.sum(1)
    return (db.sum(0, keepdim=True) if bias_b == 1 else db)[:, None, None, :]


@pytest.mark.parametrize("layout", ["plain", "grouped"])
@pytest.mark.parametrize("n,bias_b", [(11, 2), (16, 1)])
def test_plain_backward_matches_pallas_bwd_rule(interpret_mode, layout, n, bias_b):
    """reference_relpos_attention_bwd vs the TPU kernel's _bwd_rule in
    interpret mode, on the same o/LSE and cotangent, including the in-kernel
    dW and ddelta sums over the batch and the dbias fold (per-batch and
    broadcast bias); n = 11 has padded query rows on the TPU side."""
    args = list(inputs(layout, b=2, h=2, n=n, d=16, bias_b=bias_b, hdp=PRA.lane_half(16),
                       seed=n))
    args[7] = args[7] * 1e-9 * 0.3                 # a bias of moderate size, not a mask
    jargs = to_jax(args)
    _, lse_pad = PRA._forward(*jargs)
    do = rand(*args[0].shape, seed=n + 50)
    want = PRA._bwd_rule(args[8], None, tuple(jargs[:8]) + (lse_pad,), jnp.asarray(do))
    targs = to_torch(args)
    _, lse = RA.reference_relpos_attention(*targs)
    got = RA.reference_relpos_attention_bwd(*targs[:8], torch.from_numpy(do), lse, args[8])
    for g_, w_ in zip(got[:5], want[:5]):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=0, atol=TOL)
    np.testing.assert_allclose(fold_dbias(got[5], bias_b).numpy(), np.asarray(want[7]),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("layout", ["plain", "grouped"])
@pytest.mark.parametrize("bias_b", [0, 1, 2])
def test_autograd_function_matches_jax_vjp(layout, bias_b):
    """Gradients through the port's autograd Function on the CPU (plain
    forward, plain backward) vs jax.vjp of the JAX reference, for qu, k, v,
    delta, W and the bias (none, broadcast, per batch); the tables get no
    gradient."""
    args = list(inputs(layout, n=14, bias_b=max(bias_b, 1), seed=20 + bias_b))
    args[7] = args[7] * 1e-9 * 0.3 if bias_b else None
    do = rand(*args[0].shape, seed=90)
    diff = [0, 1, 2, 3, 4] + ([7] if bias_b else [])

    def jax_fn(*xs):
        full = list(to_jax(args))
        for i, x in zip(diff, xs):
            full[i] = x
        return PRA.reference_relpos_attention(*full)

    _, vjp = jax.vjp(jax_fn, *[jnp.asarray(args[i]) for i in diff])
    want = vjp(jnp.asarray(do))
    targs = to_torch(args)
    for i in diff + [5, 6]:
        targs[i] = targs[i].requires_grad_(True)
    RA.relpos_attention_bwd.launches = 0
    o, _ = RA.relpos_attention(*targs)
    o.backward(torch.from_numpy(do))
    assert RA.relpos_attention_bwd.launches == 0       # CPU tensors: the plain version
    for i, w_ in zip(diff, want):
        np.testing.assert_allclose(targs[i].grad.numpy(), np.asarray(w_), rtol=0, atol=TOL,
                                   err_msg=str(i))
    assert targs[5].grad is None and targs[6].grad is None


def test_mask_bias_gets_no_gradient_unless_asked():
    args = to_torch(inputs("plain", n=9, seed=2))
    qu = args[0].requires_grad_(True)
    o, _ = RA.relpos_attention(qu, *args[1:])
    o.sum().backward()
    assert qu.grad is not None and args[7].grad is None


# ------------------------------------------------------- the bf16 route's inputs

def bf16_round(x):
    return torch.from_numpy(np.array(x)).to(torch.bfloat16).float()


@pytest.mark.parametrize("layout,d,h", [("plain", 24, 2), ("grouped", 20, 4), ("plain", 28, 2)])
def test_tc_layout_is_exact(layout, d, h):
    """What the wrapper hands the bf16 route: delta, W and the tables cast
    to bf16 with the head width zero-padded to 16 and each rel half to 8
    (here dh 12 -> 16, 15 -> 16, 14 -> 16; hd 12 -> 16, 10 -> 16, 14 ->
    16), qu, k and v padded alike. Through the plain version, forward and
    backward (dW and ddelta brought back by tc_unpad), it gives the plain
    version's result on the bf16-rounded values: the padding adds exact
    zeros, so only the fp32 order of the sums may differ (1e-6)."""
    args = list(inputs(layout, b=2, h=h, n=13, d=d, seed=d))
    args[7] = args[7] * 1e-9 * 0.3
    qu, k, v = (bf16_round(a) for a in args[:3])
    delta, w, rowtab, keytab = (bf16_round(a) for a in args[3:7])
    bias, scale = torch.from_numpy(args[7]), args[8]
    dh, d2 = qu.shape[-1], w.shape[-1]
    dhp, hdp = RA.tc_widths(dh, d2)
    assert dhp == 16 and hdp == 16 and (dhp, hdp) != (dh, d2 // 2)
    padded = RA.tc_layout(*[torch.from_numpy(np.array(a)) for a in args[3:7]])
    assert all(t.dtype == torch.bfloat16 and t.is_contiguous() for t in padded)
    assert padded[1].shape == (h, dhp, 2 * hdp) and padded[2].shape == (13, 2 * hdp)

    def pad(t):
        return torch.nn.functional.pad(t, (0, dhp - dh))

    dp_, wp, rp, kp = (t.float() for t in padded)
    o_p, lse_p = RA.reference_relpos_attention(pad(qu), pad(k), pad(v), dp_, wp, rp, kp, bias,
                                               scale)
    o, lse = RA.reference_relpos_attention(qu, k, v, delta, w, rowtab, keytab, bias, scale)
    torch.testing.assert_close(o_p[..., :dh], o, rtol=0, atol=1e-6)
    torch.testing.assert_close(lse_p, lse, rtol=0, atol=1e-6)
    do = bf16_round(rand(*qu.shape, seed=d + 1))
    got = RA.reference_relpos_attention_bwd(pad(qu), pad(k), pad(v), dp_, wp, rp, kp, bias,
                                            pad(do), lse, scale)
    want = RA.reference_relpos_attention_bwd(qu, k, v, delta, w, rowtab, keytab, bias, do, lse,
                                             scale)
    ddelta, dw = RA.tc_unpad(got[3], got[4], dh, d2)
    for name, g_, w_ in (("dqu", got[0][..., :dh], want[0]), ("dk", got[1][..., :dh], want[1]),
                         ("dv", got[2][..., :dh], want[2]), ("ddelta", ddelta, want[3]),
                         ("dw", dw, want[4]), ("dbias", got[5], want[5])):
        torch.testing.assert_close(g_, w_, rtol=0, atol=1e-6, msg=name)
