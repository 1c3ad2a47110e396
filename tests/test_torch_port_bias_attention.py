"""PyTorch port vs the JAX package: the bias attention (ops/bias_attention.py).

On the CPU the port's wrapper runs its plain PyTorch versions; they are held
to the TPU kernels of efficientconformer_tpu/ops/pallas_attention.py in
interpret mode, as tests/test_pallas_attention.py runs them: the forward to
``fused_bias_attention`` / ``_fused_forward`` and ``_flash_forward``, the
backward to ``_fused_bwd`` (through ``jax.vjp``) and to ``_flash_backward``.
The CUDA kernels themselves are held to the plain versions on the card
(tests/test_torch_port_cuda.py, chip_smoke.py).

Each comparison runs in fp32 and in bf16. The bf16 cases feed both sides the
same bf16-rounded q, k, v (and dO) with the LM's fp32 bias: they hold the
plain versions, which the kernels' bf16 route is held to on the card, to the
TPU kernels' own bf16 rounding (P rounded before P V; bf16 outputs).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

import efficientconformer_tpu.ops.pallas_attention as pa
from efficientconformer_torch.ops import bias_attention as BA

TOL = 1e-5          # fp32, same algorithm, summation order only
BF16_O_TOL = 2e-2   # bf16: O rounded to bf16 (8 mantissa bits), P rounded by the TPU kernels
BF16_LSE_TOL = 1e-4  # bf16 inputs, fp32 scores on both sides
BF16_GRAD_TOL = 1e-2  # bf16 gradients, relative to max(max|.|, 1); _fused_bwd rounds S to bf16
NEG_INF = -1e9
DTYPES = ("float32", "bfloat16")

# (name, B, H, Nq, Nk, dqk, dv, bias shape) of each case; the bias shapes
# are the ones the attention paths give: a full (B, H, Nq, Nk) rel-pos +
# mask bias, its broadcasts over heads or batch, and key masks
CASES = {
    "full": (2, 3, 13, 13, 16, 16, "bhqk"),
    "batch-rows": (2, 3, 11, 17, 16, 16, "b1qk"),
    "head-rows": (2, 3, 9, 9, 8, 8, "1hqk"),
    "keymask": (2, 2, 13, 19, 16, 16, "b11k"),
    "keymask-shared": (2, 2, 7, 10, 12, 12, "111k"),
    "dqk-ne-dv": (2, 2, 21, 29, 90, 70, "bhqk"),
    "lm-causal": (2, 3, 37, 37, 64, 64, "bhqk"),   # the LM's head width and causal mask
}


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def case_inputs(name, seed=0, masked_row=False):
    """numpy (q, k, v, bias, scale): ragged key lengths as -1e9 columns over
    random rel-pos-like scores; with ``masked_row`` every key of query row 1
    of the first (batch, head) is masked (of every row, for a key mask)."""
    b, h, nq, nk, dqk, dv, layout = CASES[name]
    rng = np.random.default_rng(seed)
    shape = tuple({"b": b, "h": h, "q": nq, "k": nk, "1": 1}[c] for c in layout)
    bias = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    if layout[2] == "1":
        bias = np.zeros(shape, np.float32)
    lengths = np.linspace(nk // 2, nk, shape[0]).astype(int)
    bias = np.where(np.arange(nk) >= lengths[:, None, None, None], NEG_INF, bias)
    if name == "lm-causal":
        bias = np.where(np.arange(nk) > np.arange(nq)[:, None], NEG_INF, bias)
    if masked_row:
        bias[0, 0, min(1, shape[2] - 1), :] = NEG_INF
    q = rng.standard_normal((b, h, nq, dqk)).astype(np.float32)
    k = rng.standard_normal((b, h, nk, dqk)).astype(np.float32)
    v = rng.standard_normal((b, h, nk, dv)).astype(np.float32)
    return q, k, v, bias.astype(np.float32), 1.0 / np.sqrt(dqk)


def port_forward(q, k, v, bias, scale, dtype="float32"):
    """(o, lse) as fp32 / fp64 numpy; q, k, v rounded to ``dtype``, the
    bias fp32."""
    t = getattr(torch, dtype)
    o, lse = BA.bias_attention(*(torch.from_numpy(a).to(t) for a in (q, k, v)),
                               torch.from_numpy(bias), scale)
    assert o.dtype == t
    return o.float().numpy(), lse.numpy()


def jax_inputs(q, k, v, bias, dtype="float32"):
    """The same inputs for the JAX package: q, k, v as ``dtype``, the bias fp32."""
    return [jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in (q, k, v)] + [jnp.asarray(bias)]


def f32(x):
    return np.asarray(x, dtype=np.float32)


def o_tol(dtype):
    return TOL if dtype == "float32" else BF16_O_TOL


def lse_tol(dtype):
    return TOL if dtype == "float32" else BF16_LSE_TOL


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_the_single_block_kernel(interpret_mode, name, dtype):
    """O against fused_bias_attention, O and LSE against _fused_forward."""
    q, k, v, bias, scale = case_inputs(name)
    o, lse = port_forward(q, k, v, bias, scale, dtype)
    jq, jk, jv, jb = jax_inputs(q, k, v, bias, dtype)
    want = pa.fused_bias_attention(jq, jk, jv, jb, scale)
    np.testing.assert_allclose(o, f32(want), rtol=0, atol=o_tol(dtype))
    want_o, want_lse = pa._fused_forward(jq, jk, jv, jb, scale)
    np.testing.assert_allclose(o, f32(want_o), rtol=0, atol=o_tol(dtype))
    np.testing.assert_allclose(lse, np.asarray(want_lse), rtol=lse_tol(dtype), atol=lse_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["full", "keymask", "dqk-ne-dv", "lm-causal"])
def test_forward_matches_the_key_tiled_kernel(interpret_mode, name, dtype):
    q, k, v, bias, scale = case_inputs(name, seed=1)
    o, lse = port_forward(q, k, v, bias, scale, dtype)
    want_o, want_lse = pa._flash_forward(*jax_inputs(q, k, v, bias, dtype), scale)
    np.testing.assert_allclose(o, f32(want_o), rtol=0, atol=o_tol(dtype))
    np.testing.assert_allclose(lse, np.asarray(want_lse), rtol=lse_tol(dtype), atol=lse_tol(dtype))


def test_fully_masked_row_averages_the_real_keys(interpret_mode):
    """A row whose keys all carry the -1e9 mask averages V over the real
    keys, as reference_bias_attention does, and so does the single-block TPU
    kernel when Nk needs no padding (16 keys: a multiple of its 8-row
    tiles). The TPU kernels pad the keys with -1e9 columns of their own, so
    at other Nk they would average over their padding too; the port's
    kernels exclude their tile edge outright."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((1, 2, n, 8)).astype(np.float32) for n in (12, 16, 16))
    bias = (rng.standard_normal((1, 2, 12, 16)) * 0.5).astype(np.float32)
    bias[0, 0, 1, :] = NEG_INF
    scale = 1.0 / np.sqrt(8)
    o, _ = port_forward(q, k, v, bias, scale)
    np.testing.assert_allclose(o[0, 0, 1], v[0, 0].mean(0), rtol=0, atol=TOL)
    jargs = map(jnp.asarray, (q, k, v, bias))
    want = pa.reference_bias_attention(*jargs, scale)
    np.testing.assert_allclose(o, np.asarray(want), rtol=0, atol=TOL)
    want_o, _ = pa._fused_forward(*map(jnp.asarray, (q, k, v, bias)), scale)
    np.testing.assert_allclose(o, np.asarray(want_o), rtol=0, atol=TOL)


def port_grads(q, k, v, bias, scale, do, bias_grad=True, dtype="float32"):
    """(dq, dk, dv, dbias) of <O, dO> through the port's autograd Function,
    as fp32 numpy; q, k, v and dO rounded to ``dtype``, the bias fp32."""
    t = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(t).requires_grad_() for a in (q, k, v))
    tb = torch.from_numpy(bias).requires_grad_(bias_grad)
    o, _ = BA.bias_attention(tq, tk, tv, tb, scale)
    o.backward(torch.from_numpy(do).to(t))
    assert tq.grad.dtype == t and (tb.grad is None or tb.grad.dtype == torch.float32)
    return tuple(x.grad.float().numpy() if x.grad is not None else None for x in (tq, tk, tv, tb))


def assert_grad_close(got, want, dtype, label):
    """fp32: within TOL; bf16: within BF16_GRAD_TOL of max(max|want|, 1)."""
    want = f32(want)
    tol = TOL if dtype == "float32" else BF16_GRAD_TOL * max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=label)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("masked_row", [False, True])
@pytest.mark.parametrize("name", list(CASES))
def test_backward_matches_fused_bwd(interpret_mode, name, masked_row, dtype):
    """dq, dk, dv and the bias gradient, summed over the bias's broadcast
    axes, against jax.vjp through fused_bias_attention (its _fused_bwd)."""
    q, k, v, bias, scale = case_inputs(name, seed=3, masked_row=masked_row)
    do = np.random.default_rng(4).standard_normal(q.shape[:3] + v.shape[-1:]).astype(np.float32)
    got = port_grads(q, k, v, bias, scale, do, dtype=dtype)
    _, vjp = jax.vjp(lambda *a: pa.fused_bias_attention(*a, scale),
                     *jax_inputs(q, k, v, bias, dtype))
    want = vjp(jnp.asarray(do, dtype=getattr(jnp, dtype)))
    assert got[3].shape == bias.shape
    for label, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert_grad_close(g, w, dtype, label)
    assert_grad_close(got[3].sum(), f32(want[3]).sum(), dtype, "sum of dbias")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["keymask", "keymask-shared", "dqk-ne-dv"])
def test_backward_matches_the_tiled_pallas_backward(interpret_mode, monkeypatch, name, dtype):
    """dq, dk, dv against _flash_backward (the JAX package's Pallas backward
    for a key mask, forced with PALLAS_BWD) on a key mask; the port's mask
    takes no gradient."""
    monkeypatch.setattr(pa, "PALLAS_BWD", True)
    q, k, v, bias, scale = case_inputs(name, seed=5)
    if name == "dqk-ne-dv":
        bias = bias[:, :1, :1, :]
    do = np.random.default_rng(6).standard_normal(q.shape[:3] + v.shape[-1:]).astype(np.float32)
    got = port_grads(q, k, v, bias, scale, do, bias_grad=False, dtype=dtype)
    jargs = jax_inputs(q, k, v, bias, dtype)
    o, lse = pa._dispatch_forward(*jargs, scale, with_lse=True)
    want = pa._flash_backward(*jargs, o, lse, jnp.asarray(do, dtype=getattr(jnp, dtype)), scale)
    assert got[3] is None
    for label, g, w in zip(("dq", "dk", "dv"), got, want):
        assert_grad_close(g, w, dtype, label)


def test_plain_backward_is_the_vjp_of_the_plain_forward():
    """reference_bias_attention_bwd equals autograd through
    reference_bias_attention, and fold_bias_grad sums dS over the broadcast
    axes."""
    q, k, v, bias, scale = case_inputs("batch-rows", seed=7)
    tq, tk, tv, tb = (torch.from_numpy(a).double().requires_grad_() for a in (q, k, v, bias))
    do = torch.randn(tq.shape[:3] + tv.shape[-1:], dtype=torch.float64,
                     generator=torch.Generator().manual_seed(8))
    o, _ = BA.reference_bias_attention(tq, tk, tv, tb, scale)
    o.backward(do)
    dq, dk, dv, ds = BA.reference_bias_attention_bwd(tq, tk, tv, tb, do, scale)
    for g, t in zip((dq, dk, dv, BA.fold_bias_grad(ds, tb)), (tq, tk, tv, tb)):
        torch.testing.assert_close(g.double(), t.grad, rtol=0, atol=1e-6)


def test_no_gradient_when_nothing_requires_one():
    """Without tracked inputs the wrapper runs the forward alone and hands
    back no graph."""
    q, k, v, bias, scale = case_inputs("full", seed=9)
    o, lse = BA.bias_attention(*map(torch.from_numpy, (q, k, v, bias)), scale)
    assert not o.requires_grad and not lse.requires_grad
    o2, _ = BA.bias_attention(*map(torch.from_numpy, (q, k, v)), None, scale)
    want = pa.reference_bias_attention(*map(jnp.asarray, (q, k, v)),
                                       jnp.zeros((1, 1, 1, k.shape[2])), scale)
    np.testing.assert_allclose(o2.numpy(), np.asarray(want), rtol=0, atol=TOL)
