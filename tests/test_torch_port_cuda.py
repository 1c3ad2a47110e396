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
