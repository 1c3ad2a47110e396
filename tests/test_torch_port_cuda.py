"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. This file imports
neither JAX nor the JAX package, so on a machine without JAX it runs with

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

(tests/conftest.py sets up JAX for the rest of the suite).
"""

import math

import pytest
import torch

from efficientconformer_torch.ops import rel_attention as RA
from efficientconformer_torch.ops import rel_factorize as RF
from efficientconformer_torch.ops.attention import NEG_INF

FP32_TOL = 1e-4   # fp32 on both sides, summation order only
BF16_TOL = 2e-2   # O rounded to bf16 (8 mantissa bits)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def inputs(device, b, h, n, d, g, bias_b, seed=0):
    gen = torch.Generator().manual_seed(seed)
    dh = g * d // h

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    pos_kernel = randn(d, d, scale=d ** -0.5)
    w = (RF.rel_w_grouped(h, dh, pos_kernel, g, d // 2) if g > 1
         else RF.rel_w_plain(pos_kernel, h, d // 2))
    rowtab, keytab = RF.rel_tables(n, n, d, g, device)
    bias = None
    if bias_b:
        lengths = torch.linspace(max(n // 3, 1), n, bias_b).long()
        bias = ((torch.arange(n)[None] >= lengths[:, None]).float() * NEG_INF)
        bias = bias[:, None, None, :].to(device)
    return (randn(b, h, n, dh), randn(b, h, n, dh), randn(b, h, n, dh),
            randn(h, dh, scale=0.1), w, rowtab, keytab, bias, 1.0 / math.sqrt(dh))


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,h,g,bias_b", [
    (37, 24, 2, 1, 3), (37, 24, 2, 3, 3), (65, 40, 4, 1, 1), (130, 48, 2, 3, 0),
    (1, 16, 2, 1, 3), (200, 240, 4, 1, 3),
])
def test_kernel_matches_plain_version(cuda, n, d, h, g, bias_b):
    args = inputs(cuda, 3, h, n, d, g, bias_b, seed=n)
    RA.relpos_attention.launches = 0
    o, lse = RA.relpos_attention(*args)
    want_o, want_lse = RA.reference_relpos_attention(*args)
    assert RA.relpos_attention.launches == 1
    torch.testing.assert_close(o, want_o, rtol=0, atol=FP32_TOL)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=FP32_TOL)

    qkv16 = [t.to(torch.bfloat16) for t in args[:3]]
    o16, _ = RA.relpos_attention(*qkv16, *args[3:])
    want16, _ = RA.reference_relpos_attention(*[t.float() for t in qkv16], *args[3:])
    assert o16.dtype == torch.bfloat16
    torch.testing.assert_close(o16.float(), want16, rtol=0, atol=BF16_TOL)


@pytest.mark.gpu
def test_kernel_takes_strided_heads(cuda):
    """qu, k, v as head-split views of (B, N, D) projections, as the
    attention module passes them: no copy, same result."""
    b, n, d, h = 2, 29, 24, 2
    args = list(inputs(cuda, b, h, n, d, 1, 2, seed=1))
    for i in range(3):
        args[i] = args[i].transpose(1, 2).contiguous().transpose(1, 2)
        assert not args[i].is_contiguous()
    o, lse = RA.relpos_attention(*args)
    want_o, want_lse = RA.reference_relpos_attention(*args)
    torch.testing.assert_close(o, want_o, rtol=0, atol=FP32_TOL)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=FP32_TOL)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda):
    args = list(inputs(cuda, 1, 2, 8, 16, 1, 1))
    with pytest.raises(ValueError, match="dtype"):
        RA.relpos_attention(*[t.half() for t in args[:3]], *args[3:])
    with pytest.raises(ValueError, match="keytab"):
        RA.relpos_attention(*args[:6], args[6][:4], *args[7:])


# ------------------------------------------------------------ backward kernel

GRAD_NAMES = ("dqu", "dk", "dv", "ddelta", "dw", "dbias_hb")


def assert_grads_close(got, want, tol_token, tol_sum, rel_token=False):
    """Per-token gradients (dqu, dk, dv) within ``tol_token`` (absolute, or
    relative to max|.| when ``rel_token``); the batch sums dW, ddelta and
    the column sums dbias_hb within ``tol_sum`` relative to max|.|. A
    relative bound is taken against max(max|.|, 1), so that a gradient that
    is 0 in exact arithmetic is held to the absolute bound."""
    for name, g_, w_ in zip(GRAD_NAMES, got, want):
        if g_ is None:
            continue
        g_, w_ = g_.float(), w_.float()
        assert g_.shape == w_.shape, name
        err = (g_ - w_).abs().max().item()
        size = max(w_.abs().max().item(), 1.0)
        bound = tol_token * (size if rel_token else 1.0) if name in ("dqu", "dk", "dv") \
            else tol_sum * size
        assert err <= bound, f"{name}: |diff| {err} > {bound} (max|.| {size})"


def bwd_case(device, b, h, n, d, g, bias_b, seed, dtype=torch.float32):
    """(args, o, lse, dO): the forward's output and LSE from the plain version
    on the (dtype-rounded) inputs, and a random cotangent."""
    args = list(inputs(device, b, h, n, d, g, bias_b, seed))
    args[:3] = [t.to(dtype) for t in args[:3]]
    o, lse = RA.reference_relpos_attention(*args)
    gen = torch.Generator().manual_seed(seed + 100)
    do = torch.randn(o.shape, generator=gen).to(device=device, dtype=dtype)
    return args, o, lse, do


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,h,g,bias_b", [
    (37, 24, 2, 1, 3), (37, 24, 2, 3, 3), (65, 40, 4, 1, 1), (130, 48, 2, 3, 0),
    (1, 16, 2, 1, 3), (267, 120, 4, 3, 3), (401, 168, 4, 1, 3), (201, 240, 4, 1, 3),
])
def test_backward_kernel_matches_plain_version(cuda, n, d, h, g, bias_b):
    """fp32: the kernel's six gradients vs reference_relpos_attention_bwd on
    the same o, LSE and dO (the last three cases are the 16 s stage shapes
    of the flagship). bf16: the same on bf16-rounded inputs, the kernel's
    token gradients rounded to bf16."""
    args, o, lse, do = bwd_case(cuda, 3, h, n, d, g, bias_b, seed=n)
    RA.relpos_attention_bwd.launches = 0
    got = RA.relpos_attention_bwd(*args[:8], o, do, lse, args[8])
    want = RA.reference_relpos_attention_bwd(*args[:8], do, lse, args[8])
    assert RA.relpos_attention_bwd.launches == 1
    assert got[0].dtype == got[1].dtype == got[2].dtype == torch.float32
    assert_grads_close(got, want, FP32_TOL, FP32_TOL)

    args, o, lse, do = bwd_case(cuda, 3, h, n, d, g, bias_b, seed=n, dtype=torch.bfloat16)
    got = RA.relpos_attention_bwd(*args[:8], o, do, lse, args[8])
    want = RA.reference_relpos_attention_bwd(*args[:8], do, lse, args[8])
    assert got[0].dtype == torch.bfloat16
    assert_grads_close(got, want, BF16_TOL, BF16_TOL, rel_token=True)


@pytest.mark.gpu
def test_backward_kernel_takes_strided_heads(cuda):
    b, n, d, h = 2, 29, 24, 2
    args, o, lse, do = bwd_case(cuda, b, h, n, d, 1, 2, seed=3)
    for i in range(3):
        args[i] = args[i].transpose(1, 2).contiguous().transpose(1, 2)
    do = do.transpose(1, 2).contiguous().transpose(1, 2)
    o = o.transpose(1, 2).contiguous().transpose(1, 2)
    assert not (args[0].is_contiguous() or do.is_contiguous())
    got = RA.relpos_attention_bwd(*args[:8], o, do, lse, args[8])
    want = RA.reference_relpos_attention_bwd(*args[:8], do, lse, args[8])
    assert_grads_close(got, want, FP32_TOL, FP32_TOL)


@pytest.mark.gpu
def test_backward_kernel_weight_gradients_are_bitwise_repeatable(cuda):
    args, o, lse, do = bwd_case(cuda, 8, 4, 267, 120, 3, 8, seed=9)
    first = RA.relpos_attention_bwd(*args[:8], o, do, lse, args[8])
    second = RA.relpos_attention_bwd(*args[:8], o, do, lse, args[8])
    assert torch.equal(first[3], second[3]) and torch.equal(first[4], second[4])


@pytest.mark.gpu
@pytest.mark.parametrize("bias_b", [0, 1, 3])
def test_autograd_through_both_kernels(cuda, bias_b):
    """Gradients of sum(sin(o)) through relpos_attention (both kernels) vs
    autograd of the plain forward, for qu, k, v, delta, W and the bias (no
    bias, a broadcast one, a per-batch one)."""
    args = list(inputs(cuda, 3, 2, 45, 24, 3, bias_b, seed=4))
    if args[7] is not None:
        args[7] = args[7] * 1e-9 * 0.3      # a bias of moderate size, not a mask
    grads = []
    for fn, launches in ((RA.relpos_attention, 1), (RA.reference_relpos_attention, 0)):
        leaves = [t.detach().clone().requires_grad_(True) if t is not None else None
                  for t in args[:8]]
        RA.relpos_attention_bwd.launches = 0
        o, _ = fn(*leaves, args[8])
        torch.sin(o).sum().backward()
        assert RA.relpos_attention_bwd.launches == launches
        grads.append([leaves[i].grad for i in (0, 1, 2, 3, 4, 7) if leaves[i] is not None])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * max(1.0, want.abs().max().item()))
