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


@pytest.mark.parametrize("kwargs", [dict(relative_pos_enc=False), dict(causal=True),
                                    dict(group_size=2), dict(kernel_size=4),
                                    dict(stride=2), dict(linear_att=True)])
def test_unported_attention_variants_raise(kwargs):
    kwargs = {"relative_pos_enc": True, **kwargs}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MultiHeadSelfAttention(16, 2, **kwargs)


def test_full_attention_mask_raises():
    mod = port_mhsa(16, 2, 1, seed=0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mod(torch.zeros(1, 4, 16), torch.zeros(1, 1, 4, 4))
