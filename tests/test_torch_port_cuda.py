"""The port's CUDA kernels vs their plain PyTorch versions, on the card:
the rel-pos attention forward and backward, the RNN-T lattice forward and
backward, and the bias attention forward and backward (also at the
streaming encoders' shapes, with fully masked rows). Then the training
runtime on the card: a checkpoint round trip and the loader's batches
training the flagship. Then both device beams on the card against the CPU.
Then data parallelism on the one card: two gloo ranks against the
one-process step, and DDP at one NCCL rank against the step without it.

Every test here needs a CUDA device and skips without one. This file imports
neither JAX nor the JAX package, so on a machine without JAX it runs with

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

(tests/conftest.py sets up JAX for the rest of the suite).
"""

import math

import pytest
import torch

from efficientconformer_torch.ops import bias_attention as BA
from efficientconformer_torch.ops import rel_attention as RA
from efficientconformer_torch.ops import rel_factorize as RF
from efficientconformer_torch.ops import rnnt_loss as RL
from efficientconformer_torch.ops.attention import NEG_INF

FP32_TOL = 1e-4   # fp32 on both sides, summation order only
BF16_TOL = 2e-2   # O rounded to bf16 (8 mantissa bits); the rel-pos tensor-core kernels also
                  # round W, delta, the tables, qv, A, P, dS and dpq where the TPU kernel does,
                  # and so move their scores and LSE by up to ~1e-2 from the fp32 plain version


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


STAGE_SHAPES = [   # (N, D, H, G) at 16 s: the flagship's, then Transducer Small's
    (267, 120, 4, 3), (401, 168, 4, 1), (201, 240, 4, 1),
    (267, 100, 4, 3), (401, 140, 4, 1), (201, 200, 4, 1),
]


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,h,g,bias_b", [
    (37, 24, 2, 1, 3), (37, 24, 2, 3, 3), (65, 40, 4, 1, 1), (130, 48, 2, 3, 0),
    (1, 16, 2, 1, 3), (200, 240, 4, 1, 3),
    (267, 100, 4, 3, 3), (401, 140, 4, 1, 3), (201, 200, 4, 1, 3),
    (267, 120, 4, 3, 1), (401, 168, 4, 1, 3), (201, 240, 4, 1, 0),
])
def test_kernel_matches_plain_version(cuda, n, d, h, g, bias_b):
    """Cases 7-9 are Transducer Small's 16 s stage shapes (head widths 75,
    35 and 50, two of them odd; rel widths 100, 140, 200), 10-12 the
    flagship's (90, 42, 60; 120, 168, 240). fp32 runs the FMA kernel, bf16
    the tensor-core kernel (the route counter says so), held to the fp32
    plain version on the same bf16 qu, k and v."""
    args = inputs(cuda, 3, h, n, d, g, bias_b, seed=n)
    RA.relpos_attention.launches = RA.relpos_attention.tc_launches = 0
    o, lse = RA.relpos_attention(*args)
    want_o, want_lse = RA.reference_relpos_attention(*args)
    assert (RA.relpos_attention.launches, RA.relpos_attention.tc_launches) == (1, 0)
    torch.testing.assert_close(o, want_o, rtol=0, atol=FP32_TOL)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=FP32_TOL)

    qkv16 = [t.to(torch.bfloat16) for t in args[:3]]
    o16, lse16 = RA.relpos_attention(*qkv16, *args[3:])
    want16, want_lse16 = RA.reference_relpos_attention(*[t.float() for t in qkv16], *args[3:])
    assert (RA.relpos_attention.launches, RA.relpos_attention.tc_launches) == (2, 1)
    assert o16.dtype == torch.bfloat16
    torch.testing.assert_close(o16.float(), want16, rtol=0, atol=BF16_TOL)
    torch.testing.assert_close(lse16, want_lse16, rtol=0, atol=BF16_TOL)


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
    # bf16 heads of dh 12 and 15 (odd: 2-byte copies) at odd offsets
    for dd, hh, gg in ((24, 2, 1), (20, 4, 3)):
        args = list(inputs(cuda, b, hh, n, dd, gg, 2, seed=2))
        for i in range(3):
            args[i] = args[i].to(torch.bfloat16).transpose(1, 2).contiguous().transpose(1, 2)
        o, _ = RA.relpos_attention(*args)
        want_o, _ = RA.reference_relpos_attention(*[t.float() for t in args[:3]], *args[3:])
        torch.testing.assert_close(o.float(), want_o, rtol=0, atol=BF16_TOL)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda):
    """A dtype, a shape mismatch; fp32 now takes the widths of the Medium
    and Large Efficient Conformers (dh 135) and of Conformer Large (dh + D =
    576 in the backward) both ways, and refuses only a head past 256; bf16
    past its own widths (a padded head over 144, a rel width whose shared
    memory need passes 227 KB), with the bytes named. Each refusal names
    its ROADMAP item; the shared memory the wrapper computes, and its
    choice of the fp32 forward's kernel, are the kernels' own."""
    args = list(inputs(cuda, 1, 2, 8, 16, 1, 1))
    with pytest.raises(ValueError, match="dtype"):
        RA.relpos_attention(*[t.half() for t in args[:3]], *args[3:])
    with pytest.raises(ValueError, match="keytab"):
        RA.relpos_attention(*args[:6], args[6][:4], *args[7:])
    args = list(inputs(cuda, 1, 4, 20, 180, 3, 1))     # dh 135
    o, lse = RA.relpos_attention(*args)
    want_o, want_lse = RA.reference_relpos_attention(*args)
    torch.testing.assert_close(o, want_o, rtol=0, atol=FP32_TOL)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=FP32_TOL)
    args, o, lse, do = bwd_case(cuda, 1, 8, 20, 512, 1, 1, seed=5)   # dh 64, D 512
    got = RA.relpos_attention_bwd(*args[:8], o, do, lse, args[8])
    want = RA.reference_relpos_attention_bwd(*args[:8], do, lse, args[8])
    assert_grads_close(got, want, FP32_TOL, FP32_TOL)
    for dh, d in ((135, 180), (64, 512), (90, 720), (135, 360), (256, 1024)):
        for dtype in (torch.float32, torch.bfloat16):
            if dtype == torch.bfloat16 and dh > 144:
                continue
            assert RA.refusal(dtype, dh, d) is None
            assert RA.refusal(dtype, dh, d, backward=True) is None
    args = list(inputs(cuda, 1, 1, 8, 272, 1, 1))        # dh 272
    with pytest.raises(ValueError, match=r"float32 route refuses: head width 272 > 256 "
                                         r"\(ROADMAP \[27\]\)"):
        RA.relpos_attention(*args)
    assert "padded head width 160" in RA.refusal(torch.bfloat16, 150, 64)
    why = RA.refusal(torch.bfloat16, 64, 4000, backward=True)
    assert why is not None and "shared memory in the backward" in why and "ROADMAP [27]" in why
    args = list(inputs(cuda, 1, 1, 8, 200, 1, 1))        # dh 200
    with pytest.raises(ValueError, match="bfloat16 route refuses: padded head width 208"):
        RA.relpos_attention(*[t.to(torch.bfloat16) for t in args[:3]], *args[3:])
    for dh, d in ((12, 24), (135, 180), (90, 360), (64, 712), (64, 720), (90, 720), (200, 64),
                  (256, 1024), (64, 4000)):
        for dtype, code in RA._DTYPE_CODE.items():
            kernels = (RA._bind()[0].ecf_relpos_attention_fwd_smem(code, dh, d),
                       RA._bind_bwd()[0].ecf_relpos_attention_bwd_smem(code, dh, d))
            assert kernels == RA.smem_bytes(dtype, dh, d), (dh, d, dtype)
        resident = RA._bind()[0].ecf_relpos_attention_fwd_resident(dh, d)
        assert bool(resident) == RA.fma_resident(dh, d), (dh, d)


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
    (1, 16, 2, 1, 3), (267, 120, 4, 3, 3), (401, 168, 4, 1, 1), (201, 240, 4, 1, 0),
    (267, 100, 4, 3, 3), (401, 140, 4, 1, 1), (201, 200, 4, 1, 0),
])
def test_backward_kernel_matches_plain_version(cuda, n, d, h, g, bias_b):
    """fp32: the FMA kernels' six gradients vs reference_relpos_attention_bwd
    on the same o, LSE and dO (the last six cases are the 16 s stage shapes
    of the flagship and of Transducer Small, with a per-batch, a broadcast
    and no key mask). bf16: the tensor-core kernels (the route counter says
    so) vs the plain version on the same bf16 inputs, the token gradients
    rounded to bf16."""
    args, o, lse, do = bwd_case(cuda, 3, h, n, d, g, bias_b, seed=n)
    RA.relpos_attention_bwd.launches = RA.relpos_attention_bwd.tc_launches = 0
    got = RA.relpos_attention_bwd(*args[:8], o, do, lse, args[8])
    want = RA.reference_relpos_attention_bwd(*args[:8], do, lse, args[8])
    assert (RA.relpos_attention_bwd.launches, RA.relpos_attention_bwd.tc_launches) == (1, 0)
    assert got[0].dtype == got[1].dtype == got[2].dtype == torch.float32
    assert_grads_close(got, want, FP32_TOL, FP32_TOL)

    args, o, lse, do = bwd_case(cuda, 3, h, n, d, g, bias_b, seed=n, dtype=torch.bfloat16)
    got = RA.relpos_attention_bwd(*args[:8], o, do, lse, args[8])
    want = RA.reference_relpos_attention_bwd(*args[:8], do, lse, args[8])
    assert (RA.relpos_attention_bwd.launches, RA.relpos_attention_bwd.tc_launches) == (2, 1)
    assert got[0].dtype == torch.bfloat16
    assert_grads_close(got, want, BF16_TOL, BF16_TOL, rel_token=True)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,h,g", [(267, 180, 4, 3), (401, 512, 8, 1), (201, 720, 8, 1)])
def test_tensor_core_route_takes_the_medium_and_large_widths(cuda, n, d, h, g):
    """dh 135 (Efficient Conformer Medium and Large, stage 1), D 512
    (Conformer Large) and D 720 (Efficient Conformer Large, stage 3), at
    their 16 s lengths, both directions: on the tensor cores vs the plain
    version on the same bf16 inputs, and on the fp32 route (counted there,
    none on the tensor cores) vs the plain version in fp32."""
    args, o, lse, do = bwd_case(cuda, 2, h, n, d, g, 2, seed=n, dtype=torch.bfloat16)
    o16, lse16 = RA.relpos_attention_fwd(*args)
    want_o, _ = RA.reference_relpos_attention(*[t.float() for t in args[:3]], *args[3:])
    torch.testing.assert_close(o16.float(), want_o, rtol=0, atol=BF16_TOL)
    got = RA.relpos_attention_bwd(*args[:8], o, do, lse, args[8])
    want = RA.reference_relpos_attention_bwd(*args[:8], do, lse, args[8])
    assert_grads_close(got, want, BF16_TOL, BF16_TOL, rel_token=True)

    args, o, lse, do = bwd_case(cuda, 2, h, n, d, g, 2, seed=n + 1)
    RA.relpos_attention.launches = RA.relpos_attention.tc_launches = 0
    RA.relpos_attention_bwd.launches = RA.relpos_attention_bwd.tc_launches = 0
    o32, lse32 = RA.relpos_attention_fwd(*args)
    torch.testing.assert_close(o32, o, rtol=0, atol=FP32_TOL)
    torch.testing.assert_close(lse32, lse, rtol=0, atol=FP32_TOL)
    got = RA.relpos_attention_bwd(*args[:8], o, do, lse, args[8])
    want = RA.reference_relpos_attention_bwd(*args[:8], do, lse, args[8])
    assert (RA.relpos_attention.launches, RA.relpos_attention.tc_launches) == (1, 0)
    assert (RA.relpos_attention_bwd.launches, RA.relpos_attention_bwd.tc_launches) == (1, 0)
    assert_grads_close(got, want, FP32_TOL, FP32_TOL)


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
    for dd, hh, gg in ((24, 2, 1), (20, 4, 3)):   # bf16 heads of dh 12 and 15 (odd)
        args, o, lse, do = bwd_case(cuda, b, hh, n, dd, gg, 2, seed=3, dtype=torch.bfloat16)
        args[:3] = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in args[:3]]
        do, o = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (do, o))
        got = RA.relpos_attention_bwd(*args[:8], o, do, lse, args[8])
        want = RA.reference_relpos_attention_bwd(*args[:8], do, lse, args[8])
        assert_grads_close(got, want, BF16_TOL, BF16_TOL, rel_token=True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_weight_gradients_are_bitwise_repeatable(cuda, dtype):
    args, o, lse, do = bwd_case(cuda, 8, 4, 267, 120, 3, 8, seed=9, dtype=dtype)
    first = RA.relpos_attention_bwd(*args[:8], o, do, lse, args[8])
    second = RA.relpos_attention_bwd(*args[:8], o, do, lse, args[8])
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("bias_b", [0, 1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_through_both_kernels(cuda, bias_b, dtype):
    """Gradients of sum(sin(o)) through relpos_attention (both kernels) vs
    autograd of the plain forward, for qu, k, v, delta, W and the bias (no
    bias, a broadcast one, a per-batch one); in bf16 (the tensor-core
    kernels) relative to max(max|g|, 1)."""
    args = list(inputs(cuda, 3, 2, 45, 24, 3, bias_b, seed=4))
    args[:3] = [t.to(dtype) for t in args[:3]]
    if args[7] is not None:
        args[7] = args[7] * 1e-9 * 0.3      # a bias of moderate size, not a mask
    tc = dtype == torch.bfloat16
    grads = []
    for fn, launches in ((RA.relpos_attention, 1), (RA.reference_relpos_attention, 0)):
        leaves = [t.detach().clone().requires_grad_(True) if t is not None else None
                  for t in args[:8]]
        RA.relpos_attention_bwd.launches = RA.relpos_attention_bwd.tc_launches = 0
        o, _ = fn(*leaves, args[8])
        torch.sin(o.float()).sum().backward()
        assert RA.relpos_attention_bwd.launches == launches
        assert RA.relpos_attention_bwd.tc_launches == (launches if tc else 0)
        grads.append([leaves[i].grad for i in (0, 1, 2, 3, 4, 7) if leaves[i] is not None])
    tol = BF16_TOL if tc else 1e-4
    for got, want in zip(*grads):
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=tol * max(1.0, want.abs().max().item()))


# ------------------------------------------------------------ RNN-T lattice

RNNT_LOSS_RTOL = 1e-5   # the same fp32 recursion in the same order on both sides
RNNT_GRAD_TOL = 1e-5    # gradients are probabilities, at most 1


def rnnt_case(device, b, t, u1, seed):
    """Gathered log-probs of about the size a 1000-token vocabulary gives,
    ragged lengths with f_len = T, y_len = 0 and y_len = U among them."""
    gen = torch.Generator().manual_seed(seed)
    lp = (torch.randn(b, t, u1, 3, generator=gen) * 2).log_softmax(-1) - math.log(333.0)
    f_len = torch.linspace(t, max(t // 3, 1), b).round().int()
    y_len = torch.linspace(0, u1 - 1, b).round().int().flip(0)
    y_len[-1] = 0
    return (lp[..., 0].contiguous().to(device), lp[..., 1].contiguous().to(device),
            f_len.to(device), y_len.to(device))


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,u1", [(16, 201, 91), (4, 60, 150), (3, 1, 5), (2, 7, 1),
                                    (5, 33, 300), (3, 40, 32), (3, 40, 33), (3, 20, 64),
                                    (3, 20, 65), (2, 6, 1024), (4, 2, 40)])
def test_rnnt_kernels_match_plain_versions(cuda, b, t, u1):
    """Alphas and loss of the forward kernel, both gradients of the backward
    kernel on the same alphas, vs reference_rnnt_alphas / _grads on the
    card; exact zeros outside each utterance's lattice. (16, 201, 91) is the
    Transducer's training shape; U+1 = 150 and 300 take more than 128
    threads a block, 32/33 and 64/65 end on and just past a warp, 1024 is
    the most a block takes; T = 1 and 2 are shorter than the ring of staged
    diagonals, and at (4, 2, 40) the third utterance has f_len 1, y_len 13.
    The backward counts two launches: the betas, then the gradients."""
    blank, emit, f_len, y_len = rnnt_case(cuda, b, t, u1, seed=t + u1)
    RL.rnnt_alphas.launches = RL.rnnt_grads.launches = 0
    alphas, loss = RL.rnnt_alphas(blank, emit, f_len, y_len)
    want_alphas = RL.reference_rnnt_alphas(blank, emit)
    want_loss = RL.loss_from_alphas(want_alphas, blank, f_len, y_len)
    torch.testing.assert_close(alphas, want_alphas, rtol=RNNT_LOSS_RTOL, atol=RNNT_GRAD_TOL)
    torch.testing.assert_close(loss, want_loss, rtol=RNNT_LOSS_RTOL, atol=0)
    got = RL.rnnt_grads(blank, emit, alphas, f_len, y_len, -loss)
    want = RL.reference_rnnt_grads(blank, emit, alphas, f_len, y_len, -loss)
    assert RL.rnnt_alphas.launches == 1 and RL.rnnt_grads.launches == 2
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=0, atol=RNNT_GRAD_TOL)
        for i in range(b):
            f, y = int(f_len[i]), int(y_len[i])
            assert (g_[i, f:] == 0).all() and (g_[i, :, y + 1:] == 0).all()
    torch.testing.assert_close(got[0][torch.arange(b), f_len.long() - 1, y_len.long()],
                               torch.ones(b, device=cuda), rtol=1e-5, atol=0)


@pytest.mark.gpu
def test_rnnt_kernels_equal_plain_versions_bitwise_at_the_training_shape(cuda):
    """At the Transducer's training shape (B 16, T 201, U+1 91) both kernels
    run the plain versions' fp32 arithmetic in the same order, so their
    alphas, loss and gradients are equal bit for bit."""
    blank, emit, f_len, y_len = rnnt_case(cuda, 16, 201, 91, seed=0)
    alphas, loss = RL.rnnt_alphas(blank, emit, f_len, y_len)
    want_alphas = RL.reference_rnnt_alphas(blank, emit)
    assert torch.equal(alphas, want_alphas)
    assert torch.equal(loss, RL.loss_from_alphas(want_alphas, blank, f_len, y_len))
    got = RL.rnnt_grads(blank, emit, alphas, f_len, y_len, -loss)
    want = RL.reference_rnnt_grads(blank, emit, alphas, f_len, y_len, -loss)
    assert all(torch.equal(g_, w_) for g_, w_ in zip(got, want))


@pytest.mark.gpu
def test_rnnt_loss_through_both_kernels(cuda):
    """rnnt_loss from bf16 logits and its logit gradients, kernels vs the
    plain versions (the wrappers' CPU path) on the same inputs."""
    gen = torch.Generator().manual_seed(1)
    b, t, u, v = 4, 40, 12, 50
    logits = torch.randn(b, t, u + 1, v, generator=gen).bfloat16()
    labels = torch.randint(1, v, (b, u), generator=gen)
    f_len, y_len = torch.tensor([40, 31, 20, 9]), torch.tensor([12, 0, 7, 3])
    w = torch.tensor([1.0, 0.5, 2.0, 1.5])
    out = []
    for device in (cuda, "cpu"):
        lg = logits.to(device).requires_grad_(True)
        RL.rnnt_alphas.launches = RL.rnnt_grads.launches = 0
        loss = RL.rnnt_loss(lg, labels.to(device), f_len, y_len)
        (loss * w.to(device)).sum().backward()
        launched = 1 if device == cuda else 0   # the backward: two kernels a call
        assert RL.rnnt_alphas.launches == launched and RL.rnnt_grads.launches == 2 * launched
        out.append((loss.detach().cpu(), lg.grad.float().cpu()))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=RNNT_LOSS_RTOL, atol=0)
    torch.testing.assert_close(out[0][1], out[1][1], rtol=0, atol=2e-2)   # bf16 gradient


@pytest.mark.gpu
def test_rnnt_kernels_refuse_what_they_do_not_take(cuda):
    blank, emit, f_len, y_len = rnnt_case(cuda, 2, 5, 4, seed=0)
    with pytest.raises(ValueError, match="emit"):
        RL.rnnt_alphas(blank, emit[:, :, :3], f_len, y_len)
    wide = torch.zeros(1, 2, RL.MAX_U1 + 1, device=cuda)
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="label positions"):
        RL.rnnt_alphas(wide, wide, one, one)


@pytest.mark.gpu
@pytest.mark.parametrize("geometry", [(64, 8, 4 * (64 + 8 * 2 * 96)),   # fewer threads than U+1
                                      (96, 3, 4 * (64 + 3 * 2 * 96)),   # another ring than the kernels'
                                      (96, 8, 4 * 64)])                 # too little shared memory
def test_rnnt_entry_points_refuse_a_geometry_they_do_not_take(cuda, monkeypatch, geometry):
    """The C entry points check the launch geometry the wrapper hands them
    and launch nothing on what they do not take; the wrapper raises."""
    blank, emit, f_len, y_len = rnnt_case(cuda, 2, 5, 91, seed=0)
    alphas, loss = RL.rnnt_alphas(blank, emit, f_len, y_len)
    monkeypatch.setattr(RL, "launch_geometry", lambda u1: geometry)
    with pytest.raises(RuntimeError, match="launch failed"):
        RL.rnnt_alphas(blank, emit, f_len, y_len)
    with pytest.raises(RuntimeError, match="launch failed"):
        RL.rnnt_grads(blank, emit, alphas, f_len, y_len, -loss)


# ------------------------------------------------------------ bias attention

BIAS_LAYOUTS = {"full": "bhqk", "batch": "b1qk", "head": "1hqk", "keymask": "b11k",
                "none": None}


def bias_case(device, b, h, nq, nk, dqk, dv, layout, seed, dtype=torch.float32,
              masked_row=False):
    """(q, k, v, bias, scale) on the card: a bias of the given layout, random
    rel-pos-like scores with ragged key lengths as -1e9 columns, and with
    ``masked_row`` one query row of the first (batch, head) (every row, for
    a key mask) whose keys are all masked."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, h, n, w, generator=gen) for n, w in ((nq, dqk), (nk, dqk), (nk, dv)))
    bias = None
    if layout is not None:
        shape = tuple({"b": b, "h": h, "q": nq, "k": nk, "1": 1}[c] for c in layout)
        bias = torch.randn(shape, generator=gen) * 0.5 if layout[2] == "q" else torch.zeros(shape)
        lengths = torch.linspace(max(nk // 2, 1), nk, shape[0]).long()
        bias = bias.masked_fill(torch.arange(nk) >= lengths[:, None, None, None], NEG_INF)
        if masked_row:
            bias[0, 0, min(1, shape[2] - 1)] = NEG_INF
        bias = bias.to(device)
    return (q.to(device, dtype), k.to(device, dtype), v.to(device, dtype), bias,
            1.0 / math.sqrt(dqk))


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,nq,nk,dqk,dv,layout", [
    (8, 12, 101, 101, 64, 64, "full"),     # the LM-Transformer's shape
    (3, 2, 37, 37, 64, 64, "batch"), (3, 2, 65, 130, 32, 32, "head"),
    (3, 2, 70, 70, 16, 16, "keymask"), (2, 2, 130, 65, 90, 70, "full"),
    (2, 3, 1, 1, 128, 128, "full"), (2, 2, 64, 64, 8, 24, "none"),
    (2, 4, 90, 90, 135, 135, "full"),      # EfficientConformer Medium/Large's stage 1, causal
    (2, 2, 70, 45, 256, 256, "keymask"), (2, 2, 33, 70, 200, 136, "full"),
])
def test_bias_kernel_matches_plain_version(cuda, b, h, nq, nk, dqk, dv, layout):
    """fp32 O and LSE, then bf16 O on bf16-rounded inputs; a fully masked
    row averages over the real keys, not over the tile's padding."""
    masked = layout != "none"
    args = bias_case(cuda, b, h, nq, nk, dqk, dv, BIAS_LAYOUTS[layout], seed=nq,
                     masked_row=masked)
    BA.bias_attention.launches = 0
    o, lse = BA.bias_attention(*args)
    want_o, want_lse = BA.reference_bias_attention(*args)
    assert BA.bias_attention.launches == 1 and lse.dtype == torch.float64
    torch.testing.assert_close(o, want_o, rtol=0, atol=FP32_TOL)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=FP32_TOL)
    if masked and BIAS_LAYOUTS[layout][2] == "q" and nq > 1:
        torch.testing.assert_close(o[0, 0, 1], args[2][0, 0].mean(0), rtol=0, atol=FP32_TOL)

    a16 = [t.to(torch.bfloat16) for t in args[:3]]
    o16, _ = BA.bias_attention(*a16, *args[3:])
    want16, _ = BA.reference_bias_attention(*[t.float() for t in a16], *args[3:])
    assert o16.dtype == torch.bfloat16
    torch.testing.assert_close(o16.float(), want16, rtol=0, atol=BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("b,nk", [(1, 1), (1, 64), (1, 65), (1, 100), (16, 128), (16, 129),
                                  (16, 200)])
def test_bias_kernel_at_one_query_row(cuda, b, nk):
    """The growing-cache LM step's shape (one query row, H 12, dh 64, keys
    across the 64-key tile edges): fp32 O and LSE, then bf16 O on the
    tensor-core route, against the plain version."""
    args = bias_case(cuda, b, 12, 1, nk, 64, 64, "bhqk", seed=nk)
    BA.bias_attention.launches = BA.bias_attention.tc_launches = 0
    o, lse = BA.bias_attention(*args)
    want_o, want_lse = BA.reference_bias_attention(*args)
    torch.testing.assert_close(o, want_o, rtol=0, atol=FP32_TOL)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=FP32_TOL)
    a16 = [t.to(torch.bfloat16) for t in args[:3]]
    o16, _ = BA.bias_attention(*a16, *args[3:])
    want16, _ = BA.reference_bias_attention(*[t.float() for t in a16], *args[3:])
    torch.testing.assert_close(o16.float(), want16, rtol=0, atol=BF16_TOL)
    assert (BA.bias_attention.launches, BA.bias_attention.tc_launches) == (2, 1)


@pytest.mark.gpu
def test_growing_cache_step_on_the_card_matches_the_cpu(cuda):
    """A narrow LM-Transformer stepped 20 tokens on the growing cache on
    the card (the bias kernel at one query row, counted) and on the CPU."""
    from efficientconformer_torch.models.lm import LanguageModel
    from efficientconformer_torch.models.model_ctc import init_params_

    params = {"arch": "Transformer", "num_blocks": 2, "dim_model": 64, "ff_ratio": 2,
              "num_heads": 4, "vocab_size": 32, "relative_pos_enc": True,
              "max_pos_encoding": 64, "Pdrop": 0.0}
    cpu = LanguageModel(params, 32)
    init_params_(cpu, torch.Generator().manual_seed(0))
    card = LanguageModel(params, 32).to(cuda)
    card.load_state_dict(cpu.state_dict())
    tokens = torch.randint(1, 32, (3, 20), generator=torch.Generator().manual_seed(1))
    BA.bias_attention.launches = 0
    with torch.no_grad():
        got = want = None
        for t in range(tokens.shape[1]):
            logits, got = card.eval().step(tokens[:, t].to(cuda), got)
            ref, want = cpu.eval().step(tokens[:, t], want)
            torch.testing.assert_close(logits.cpu(), ref, rtol=0, atol=FP32_TOL)
    assert BA.bias_attention.launches == 2 * tokens.shape[1]


def streaming_bias(b, h, frames, g, left, right, lengths, gen):
    """The bias a causal (right 0) or limited-context encoder layer hands
    the kernel over ``frames`` stage frames: skewed rel-pos-like scores plus
    its streaming mask, padded to a multiple of G with 1.0 and taken at each
    group's first frame, times -1e9. Query rows past a row's length plus
    the left context, and a padded query group, see no valid key."""
    from efficientconformer_torch.ops import masks as M

    mask = M.streaming_mask(frames, lengths, left, right)
    mask = M.pad_mask_to_multiple(mask, g)[:, :, ::g, ::g]
    n = mask.shape[-1]
    return torch.randn(b, h, n, n, generator=gen) * 0.5 + mask * NEG_INF, mask


STREAM_SHAPES = [   # EfficientConformerCTCSmall's stages on an 88-frame window
    (352, 3, 90), (176, 1, 42), (88, 1, 60),   # (stage frames, G, head width)
]


@pytest.mark.gpu
@pytest.mark.parametrize("frames,g,dh", STREAM_SHAPES)
@pytest.mark.parametrize("right", [0, 2])
def test_bias_kernel_at_streaming_shapes(cuda, frames, g, dh, right):
    """The flagship's three stage shapes of a causal (right 0) and a
    limited-context (right 2) window at left context 64, ragged lengths:
    fp32 and bf16 O against the plain version, and on the fully masked rows
    the mean of V over every key, as the JAX package's XLA route gives."""
    b, h = 4, 4
    gen = torch.Generator().manual_seed(frames + right)
    lengths = torch.tensor([frames, frames // 2, frames // 5, 1])
    bias, mask = streaming_bias(b, h, frames, g, 64, right, lengths, gen)
    n = bias.shape[-1]
    dead = (mask == 1.0).all(-1)[:, 0]                       # (B, N) fully masked rows
    assert bool(dead.any())
    q, k, v = (torch.randn(b, h, n, dh, generator=gen).to(cuda) for _ in range(3))
    bias = bias.to(cuda)
    scale = 1.0 / math.sqrt(dh)
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        args = [t.to(dtype) for t in (q, k, v)]
        o, lse = BA.bias_attention(*args, bias, scale)
        want_o, want_lse = BA.reference_bias_attention(*args, bias, scale)
        torch.testing.assert_close(o.float(), want_o.float(), rtol=0, atol=tol)
        if dtype == torch.float32:
            torch.testing.assert_close(lse, want_lse, rtol=0, atol=FP32_TOL)
        mean_v = args[2].float().mean(2, keepdim=True).expand(b, h, n, dh)
        rows = dead.to(cuda)[:, None, :].expand(b, h, n)
        torch.testing.assert_close(o.float()[rows], mean_v[rows], rtol=0, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("context", [{"causal": True, "left_context": 64},
                                     {"left_context": 64, "right_context": 8}])
def test_wide_streaming_encoder_on_the_card(cuda, context):
    """EfficientConformer Medium's stage 1 (G 3 x 180 / 4 heads = head width
    135), causal or limited-context, runs on the card through the bias
    kernels (fp32 route) and matches the CPU's plain versions (logits within
    1e-3)."""
    import json

    from efficientconformer_torch.models.model_ctc import ModelCTC, init_params_

    torch.backends.cudnn.allow_tf32 = False
    with open("configs/EfficientConformerCTCMedium.json") as f:
        cfg = json.load(f)
    model = ModelCTC(dict(cfg["encoder_params"], **context), 256)
    init_params_(model, torch.Generator().manual_seed(0))
    model.eval()
    x = torch.randn(2, 16000, generator=torch.Generator().manual_seed(1)) * 0.1
    x_len = torch.tensor([16000, 12000])
    with torch.no_grad():
        want, want_len = model(x, x_len)
        BA.bias_attention.launches = 0
        got, got_len = model.to(cuda)(x.to(cuda), x_len.to(cuda))
    assert BA.bias_attention.launches > 0
    assert torch.equal(got_len.cpu(), want_len)
    for i, n in enumerate(want_len.tolist()):
        torch.testing.assert_close(got[i, :n].cpu(), want[i, :n], rtol=0, atol=1e-3)


@pytest.mark.gpu
def test_bias_kernel_takes_strided_heads_and_a_bf16_bias(cuda):
    """q, k, v as head-split views of (B, N, D) projections, as the
    attention module passes them, and a bf16 bias, read in place."""
    q, k, v, bias, scale = bias_case(cuda, 2, 3, 45, 45, 16, 16, "bhqk", seed=5)
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    assert not q.is_contiguous()
    for b_ in (bias, bias.bfloat16()):
        o, lse = BA.bias_attention(q, k, v, b_, scale)
        want_o, want_lse = BA.reference_bias_attention(q, k, v, b_, scale)
        torch.testing.assert_close(o, want_o, rtol=0, atol=FP32_TOL)
        torch.testing.assert_close(lse, want_lse, rtol=0, atol=FP32_TOL)


@pytest.mark.gpu
def test_bias_kernels_refuse_what_they_do_not_take(cuda):
    q, k, v, bias, scale = bias_case(cuda, 1, 2, 8, 8, 16, 16, "bhqk", seed=1)
    with pytest.raises(ValueError, match="dtype"):
        BA.bias_attention(q.half(), k.half(), v.half(), bias, scale)
    with pytest.raises(ValueError, match="at most 256"):
        wide = torch.zeros(1, 2, 8, 260, device=cuda)
        BA.bias_attention(wide, wide, v, bias, scale)
    with pytest.raises(ValueError, match="bias"):
        BA.bias_attention(q, k, v, bias[:, :, :3], scale)
    # the tensor-core entry points take 16-byte rows only; the wrapper pads
    # all others (_pad8), so without it width 20 is refused
    odd = torch.zeros(1, 2, 8, 20, device=cuda, dtype=torch.bfloat16)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(BA, "_pad8", lambda tensors: tensors)
        with pytest.raises(RuntimeError, match="launch failed"):
            BA.bias_attention_fwd(odd, odd, odd, None, scale)
    assert BA.bias_attention_fwd(odd, odd, odd, None, scale)[0].shape == odd.shape


def assert_bias_grads_close(got, want, tol):
    """dq, dk, dv and dS within ``tol`` relative to max(max|.|, 1)."""
    for name, g_, w_ in zip(("dq", "dk", "dv", "ds"), got, want):
        err = (g_.float() - w_.float()).abs().max().item()
        size = max(w_.abs().max().item(), 1.0)
        assert err <= tol * size, f"{name}: |diff| {err} > {tol * size}"


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,nq,nk,dqk,dv,layout", [
    (8, 12, 101, 101, 64, 64, "full"), (3, 2, 37, 37, 64, 64, "batch"),
    (3, 2, 65, 130, 32, 32, "head"), (3, 2, 70, 70, 16, 16, "keymask"),
    (2, 2, 130, 65, 90, 70, "full"), (2, 3, 1, 1, 128, 128, "full"),
    (2, 4, 90, 90, 135, 135, "full"), (2, 2, 70, 45, 256, 256, "keymask"),
    (2, 2, 33, 70, 200, 136, "full"),
])
def test_bias_backward_kernel_matches_plain_version(cuda, b, h, nq, nk, dqk, dv, layout):
    """fp32 dq, dk, dv and dS vs reference_bias_attention_bwd on the same
    inputs and dO, with one fully masked row; bf16 the same on bf16-rounded
    inputs."""
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        args = bias_case(cuda, b, h, nq, nk, dqk, dv, BIAS_LAYOUTS[layout], seed=nk,
                         dtype=dtype, masked_row=True)
        o, lse = BA.bias_attention_fwd(*args)
        gen = torch.Generator().manual_seed(nq)
        do = torch.randn(o.shape, generator=gen).to(cuda, dtype)
        BA.bias_attention_bwd.launches = 0
        got = BA.bias_attention_bwd(*args[:4], o, do, lse, args[4])
        want = BA.reference_bias_attention_bwd(*args[:4], do, args[4])
        assert BA.bias_attention_bwd.launches == 1 and got[0].dtype == dtype
        assert_bias_grads_close(got, want, tol)
        _, _, _, none = BA.bias_attention_bwd(*args[:4], o, do, lse, args[4], need_dbias=False)
        assert none is None


@pytest.mark.gpu
def test_bias_backward_kernel_is_bitwise_repeatable(cuda):
    args = bias_case(cuda, 8, 12, 101, 101, 64, 64, "bhqk", seed=3)
    o, lse = BA.bias_attention_fwd(*args)
    do = torch.randn_like(o)
    first = BA.bias_attention_bwd(*args[:4], o, do, lse, args[4])
    second = BA.bias_attention_bwd(*args[:4], o, do, lse, args[4])
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["full", "batch", "head", "keymask"])
def test_bias_autograd_through_both_kernels(cuda, layout):
    """Gradients of sum(sin(o)) in q, k, v and the bias through
    bias_attention (both kernels) vs autograd of the plain forward; the
    bias's gradient folded to its own shape."""
    args = bias_case(cuda, 3, 2, 45, 45, 24, 24, BIAS_LAYOUTS[layout], seed=4)
    grads = []
    for fn, launches in ((BA.bias_attention, 1), (BA.reference_bias_attention, 0)):
        leaves = [t.detach().clone().requires_grad_(True) for t in args[:4]]
        BA.bias_attention_bwd.launches = 0
        o, _ = fn(*leaves, args[4])
        torch.sin(o).sum().backward()
        assert BA.bias_attention_bwd.launches == launches
        grads.append([t.grad for t in leaves])
    assert grads[0][3].shape == args[3].shape
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * max(1.0, want.abs().max().item()))


def heads_view(t):
    """A (B, H, N, d) tensor as the attention module passes it: a head-split
    view of a (B, N, H, d) projection."""
    return t.transpose(1, 2).contiguous().transpose(1, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,nq,nk,dqk,dv,bias16", [
    (8, 12, 101, 101, 64, 64, False),      # the LM's shape and fp32 bias: the one-pass backward
    (8, 12, 101, 101, 64, 64, True),       # the same with a bf16 bias
    (4, 4, 130, 130, 90, 70, False),       # two passes: N > 128, widths not multiples of 8,
                                           # so the rows are padded to 96 / 72
    (3, 2, 45, 70, 32, 48, False),         # one pass, Nq != Nk
    (2, 3, 50, 50, 36, 20, False),         # one pass, rows padded to 40 / 24
    (2, 2, 40, 140, 64, 64, False),        # two passes: Nk > 128
    (2, 4, 90, 90, 135, 135, False),       # width 135: padded to 136, the 144-wide instance
    (2, 2, 70, 45, 256, 256, True),        # width 256: two full column blocks
    (2, 3, 64, 64, 168, 168, False),       # width 168: at 256, the second column block
                                           # holds 40 of its 128 columns
    (2, 2, 33, 70, 200, 136, False),       # dqk != dv past 128
])
def test_bias_tensor_core_route_matches_plain_version(cuda, b, h, nq, nk, dqk, dv, bias16):
    """bf16 forward and backward through the tensor-core kernels, on
    strided heads with one fully masked row, vs the plain versions on the
    same bf16 inputs; the route counters show that both went through them.
    The backward runs in one pass at Nq, Nk <= 128 and widths <= 64, else
    in two."""
    q, k, v, bias, scale = bias_case(cuda, b, h, nq, nk, dqk, dv, "bhqk", seed=nq + dqk,
                                     dtype=torch.bfloat16, masked_row=True)
    q, k, v = (heads_view(t) for t in (q, k, v))
    assert not q.is_contiguous()
    if bias16:
        bias = bias.bfloat16()
    BA.bias_attention.launches = BA.bias_attention.tc_launches = 0
    BA.bias_attention_bwd.launches = BA.bias_attention_bwd.tc_launches = 0
    o, lse = BA.bias_attention_fwd(q, k, v, bias, scale)
    want_o, want_lse = BA.reference_bias_attention(q, k, v, bias, scale)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float64
    torch.testing.assert_close(o.float(), want_o.float(), rtol=0, atol=BF16_TOL)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=BF16_TOL)
    torch.testing.assert_close(o[0, 0, 1].float(), v[0, 0].float().mean(0), rtol=0, atol=BF16_TOL)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(nk)).to(cuda, torch.bfloat16)
    got = BA.bias_attention_bwd(q, k, v, bias, o, do, lse, scale)
    want = BA.reference_bias_attention_bwd(q, k, v, bias, do, scale)
    assert got[0].dtype == torch.bfloat16 and got[3].dtype == torch.float32
    assert_bias_grads_close(got, want, BF16_TOL)
    assert (BA.bias_attention.launches, BA.bias_attention.tc_launches) == (1, 1)
    assert (BA.bias_attention_bwd.launches, BA.bias_attention_bwd.tc_launches) == (1, 1)


@pytest.mark.gpu
def test_bias_route_is_chosen_by_dtype(cuda):
    """fp32 goes through the FMA kernels, bf16 through the tensor-core ones,
    forward and backward, by the route counters."""
    args = bias_case(cuda, 2, 3, 45, 45, 64, 64, "bhqk", seed=6)
    for dtype, tc in ((torch.float32, 0), (torch.bfloat16, 1)):
        q, k, v = (t.to(dtype).requires_grad_() for t in args[:3])
        BA.bias_attention.launches = BA.bias_attention.tc_launches = 0
        BA.bias_attention_bwd.launches = BA.bias_attention_bwd.tc_launches = 0
        o, _ = BA.bias_attention(q, k, v, args[3], args[4])
        o.float().sum().backward()
        assert (BA.bias_attention.launches, BA.bias_attention.tc_launches) == (1, tc)
        assert (BA.bias_attention_bwd.launches, BA.bias_attention_bwd.tc_launches) == (1, tc)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d", [(101, 64), (130, 64)])   # one pass, two passes
def test_bias_tensor_core_backward_is_bitwise_repeatable(cuda, n, d):
    args = bias_case(cuda, 8, 12, n, n, d, d, "bhqk", seed=3, dtype=torch.bfloat16)
    o, lse = BA.bias_attention_fwd(*args)
    do = torch.randn_like(o)
    first = BA.bias_attention_bwd(*args[:4], o, do, lse, args[4])
    second = BA.bias_attention_bwd(*args[:4], o, do, lse, args[4])
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# ---------------------------------------------------------------- training runtime

FLAGSHIP = "configs/EfficientConformerCTCSmall.json"
STEP_RTOL = 1e-5   # loss and gradient norm of the same step from the same state


def flagship_config(**training):
    """The flagship at full width and its own training_params (bf16), with
    dropout 0 and SpecAugment off so that two trainers draw no masks."""
    from efficientconformer_torch.config import load_config

    cfg = load_config(FLAGSHIP)
    cfg["encoder_params"].update(Pdrop=0.0, spec_augment=False)
    cfg["training_params"].update(training)
    return cfg


def flagship_batch(seed):
    """Two microbatches of 4 utterances of 3-6 s with 20-token labels."""
    gen = torch.Generator().manual_seed(seed)
    audio_len = torch.tensor([[48000, 60000, 72000, 96000], [96000, 80000, 50000, 64000]])
    audio = torch.randn(2, 4, 96000, generator=gen) * 0.1
    audio *= torch.arange(96000)[None, None, :] < audio_len[..., None]
    return {"audio": audio, "audio_len": audio_len,
            "labels": torch.randint(1, 256, (2, 4, 20), generator=gen),
            "label_len": torch.full((2, 4), 20)}


def same(got, want):
    if isinstance(want, dict):
        return got.keys() == want.keys() and all(same(got[k], want[k]) for k in want)
    if isinstance(want, (list, tuple)):
        return len(got) == len(want) and all(same(g, w) for g, w in zip(got, want))
    if torch.is_tensor(want):
        return got.dtype == want.dtype and got.device == want.device and torch.equal(got, want)
    return got == want


@pytest.mark.gpu
def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """Parameters, BatchNorm buffers, Adam state and step, bit for bit, in
    a fresh trainer on the card; then both trainers take the same next
    step (loss and gradient norm <= 1e-5 relative)."""
    import copy

    from efficientconformer_torch.training.trainer import Trainer

    cfg = flagship_config()
    trainer = Trainer(cfg, device=cuda, seed=0)
    trainer.train_step(flagship_batch(0))
    path = str(tmp_path / "checkpoints_1.ckpt")
    trainer.save(path)
    saved = copy.deepcopy({"model": trainer.model.state_dict(),
                           "optimizer": trainer.optimizer.state_dict()})
    fresh = Trainer(cfg, device=cuda, seed=5)
    fresh.load(path)
    assert fresh.step == trainer.step == 1
    assert same(fresh.model.state_dict(), saved["model"])
    assert same(fresh.optimizer.state_dict(), saved["optimizer"])
    assert next(iter(fresh.optimizer.state.values()))["exp_avg"].device.type == "cuda"
    batch = flagship_batch(1)
    (loss, norm), (want_loss, want_norm) = fresh.train_step(batch), trainer.train_step(batch)
    assert abs(float(loss) - float(want_loss)) <= STEP_RTOL * abs(float(want_loss))
    assert abs(float(norm) - float(want_norm)) <= STEP_RTOL * abs(float(want_norm))


@pytest.mark.gpu
def test_loader_batches_train_the_flagship(cuda, tmp_path):
    """The loader's numpy batches of a prepared mini-LibriSpeech, handed to
    the flagship's epoch loop as they are: 2 steps of 2 microbatches, each
    launching the rel-pos kernels once per block and microbatch, on the
    tensor cores (bf16)."""
    from test_e2e import make_dataset

    from efficientconformer_torch.data import datasets, loader, preparation
    from efficientconformer_torch.training.trainer import Trainer

    root = str(tmp_path / "LibriSpeech")
    make_dataset(root)
    cfg = flagship_config(batch_size=2, accumulated_steps=2, training_dataset_path=root,
                          epochs=1)
    cfg["tokenizer_params"]["tokenizer_path"] = str(tmp_path / "bpe_256.model")
    tp, kp = cfg["training_params"], cfg["tokenizer_params"]
    preparation.prepare_dataset(tp, kp, preparation.create_tokenizer(tp, kp))
    ds = datasets.LibriSpeechDataset(root, "train", vocab_size=256)
    ld = loader.AsrBatchLoader(ds, 2, accum_steps=2, num_workers=2)
    trainer = Trainer(cfg, device=cuda, seed=0)
    RA.relpos_attention.launches = RA.relpos_attention.tc_launches = 0
    RA.relpos_attention_bwd.launches = RA.relpos_attention_bwd.tc_launches = 0
    history = trainer.fit_epochs(ld.epoch, epochs=1, steps_per_epoch=2,
                                 callback_path=str(tmp_path / "cb"))
    assert len(history) == 1 and history[0]["steps"] == 2
    assert math.isfinite(history[0]["loss"]) and trainer.step == 2
    n = 2 * 2 * cfg["encoder_params"]["num_blocks"]
    assert (RA.relpos_attention.launches, RA.relpos_attention.tc_launches) == (n, n)
    assert (RA.relpos_attention_bwd.launches, RA.relpos_attention_bwd.tc_launches) == (n, n)
    assert (tmp_path / "cb" / "checkpoints_1.ckpt").exists()


@pytest.mark.gpu
def test_device_beams_on_the_card_match_the_cpu(cuda, tmp_path):
    """The CTC prefix beam (peaky log-probs, W 8, a synthetic 3-gram) and
    the Transducer beam (a 2-block Transducer with the n-gram and an
    LM-Transformer of width 16 in both routings, or an LM-RNN; fp32, W 4)
    on the card give the CPU's tokens on the same inputs and weights, and
    the Transducer's final normalised scores within 1e-4. On the card the
    LM step and the n-gram rescoring run as CUDA graphs."""
    import json

    import numpy as np

    from ngram_synth import synth_arpa

    from efficientconformer_torch.decoding.ctc_beam_device import ctc_beam_search_device
    from efficientconformer_torch.decoding.ngram import ArpaLM
    from efficientconformer_torch.decoding.rnnt_beam_device import beam_search_device
    from efficientconformer_torch.models.lm import LanguageModel
    from efficientconformer_torch.models.model_ctc import init_params_
    from efficientconformer_torch.models.transducer import Transducer

    synth_arpa(str(tmp_path / "lm3.arpa"), vocab=16, order=3, counts=(0, 40, 60), seed=1)
    arpa = ArpaLM(str(tmp_path / "lm3.arpa"))
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 30, 16)) * 3.0
    lp = torch.from_numpy(logits).float().log_softmax(-1)
    seq_len = torch.tensor([30, 24, 17])
    want = ctc_beam_search_device(lp, seq_len, 8, ngram=arpa, alpha=0.4, beta=0.3)
    got = ctc_beam_search_device(lp.to(cuda), seq_len.to(cuda), 8, ngram=arpa, alpha=0.4,
                                 beta=0.3)
    assert got == want

    with open("configs/EfficientConformerTransducerSmall.json") as f:
        cfg = json.load(f)
    enc = dict(cfg["encoder_params"], num_blocks=2, dim_model=[24, 36], num_heads=4,
               subsampling_filters=[8], strided_blocks=[1], expand_blocks=[1], kernel_size=7)
    dec = dict(cfg["decoder_params"], dim_model=16, vocab_size=16)
    model = Transducer(enc, dec, {"joint_mode": "sum", "dim_model": 12, "act": "tanh"}, 16)
    lm = LanguageModel({"arch": "Transformer", "num_blocks": 2, "dim_model": 16, "ff_ratio": 2,
                        "num_heads": 2, "vocab_size": 16, "relative_pos_enc": True,
                        "max_pos_encoding": 64, "Pdrop": 0.0}, 16)
    rnn_lm = LanguageModel({"arch": "RNN", "num_layers": 1, "dim_model": 12, "vocab_size": 16}, 16)
    init_params_(model, torch.Generator().manual_seed(0))
    init_params_(lm, torch.Generator().manual_seed(1))
    init_params_(rnn_lm, torch.Generator().manual_seed(2))
    with torch.no_grad():
        model.joint_network.linear_encoder.weight.mul_(4.0)
        model.joint_network.linear_joint.bias[0] += 5.0
    t = np.arange(640) / 16000
    x = torch.from_numpy(np.concatenate([
        rng.uniform(0.01, 1.0) * np.sin(2 * np.pi * rng.uniform(100, 6000) * t)
        for _ in range(2 * 19)]).reshape(2, -1)[:, :12000].astype(np.float32))
    x_len = torch.tensor([12000, 9000])
    for ref_topk, lm_model in ((False, lm), (True, lm), (False, rnn_lm)):
        kw = dict(beam_size=4, max_tokens=48, lm_weight=0.5, ngram=arpa, ngram_alpha=0.6,
                  ngram_beta=0.4, ref_topk=ref_topk, return_scores=True)
        want, want_sc = beam_search_device(model.eval(), x, x_len, lm_model=lm_model.eval(), **kw)
        got, got_sc = beam_search_device(model.to(cuda), x.to(cuda), x_len.to(cuda),
                                         lm_model=lm_model.to(cuda), **kw)
        model.cpu(), lm_model.cpu()
        assert got == want
        assert torch.allclose(got_sc, want_sc, rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_two_gloo_ranks_on_the_card_match_the_one_process_step(cuda):
    """Data parallelism on one card: two ranks over gloo (NCCL refuses two
    ranks on one device), each stepping on its 2 rows of flagship_batch's
    2 x 4 utterances under DDP and the globally synced BatchNorm (fp32, SGD
    at 1e-3), give the one-process step over the global batch: loss and
    gradient norm <= STEP_RTOL relative, the updated parameters and the
    BatchNorm statistics <= FP32_TOL, equal across the ranks; each rank
    launches the rel-pos kernels once a block and microbatch."""
    from efficientconformer_torch import dryrun
    from efficientconformer_torch.parallel import mesh

    cfg = flagship_config(mixed_precision=False, optimizer="SGD", momentum=0.0,
                          weight_decay=0.0, lr_schedule="Constant", lr_value=1e-3)
    case = {"config": cfg, "batch": {k: v.numpy() for k, v in flagship_batch(2).items()},
            "allow_tf32": False}
    ranks = [r[0] for r in mesh.launch(dryrun.shard_steps, 2, ([case],), device_type="cuda",
                                       backend="gloo", timeout=300)]
    one = dryrun.shard_step(**case, device=cuda)
    n = 2 * cfg["encoder_params"]["num_blocks"]
    for r in ranks:
        assert r["ddp"] and r["world"] == 2
        assert abs(r["loss"] - one["loss"]) <= STEP_RTOL * abs(one["loss"])
        assert abs(r["grad_norm"] - one["grad_norm"]) <= STEP_RTOL * abs(one["grad_norm"])
        assert (r["launches"]["relpos_fwd"], r["launches"]["relpos_bwd"]) == (n, n)
        for key in ("params", "buffers"):
            for name, want in one[key].items():
                if want.is_floating_point():
                    scale = max(want.abs().max().item(), 1.0)
                    assert (r[key][name] - want).abs().max().item() <= FP32_TOL * scale, name
                assert torch.equal(r[key][name], ranks[0][key][name]), name


@pytest.mark.gpu
def test_one_nccl_rank_ddp_step_is_the_step_without_ddp(cuda):
    """DDP at one rank over NCCL on the flagship's bf16 step: the loss,
    gradient norm, parameters and buffers bit for bit those of the trainer
    without DDP."""
    from efficientconformer_torch import dryrun
    from efficientconformer_torch.parallel import mesh

    cfg = flagship_config()
    batch = {k: v.numpy() for k, v in flagship_batch(3).items()}
    with mesh.process_group(0, 1, "cuda"):
        got = dryrun.shard_step(cfg, batch, device=cuda, ddp=True)
    want = dryrun.shard_step(cfg, batch, device=cuda, ddp=False)
    assert got["ddp"] and not want["ddp"] and got["ddp_all_reduces"] > 0
    assert got["loss"] == want["loss"] and got["grad_norm"] == want["grad_norm"]
    for key in ("params", "buffers"):
        for name, w in want[key].items():
            assert torch.equal(got[key][name], w), name
