"""PyTorch port vs the JAX package: the RNN-T loss, on the CPU in fp32.

The plain versions of the port's lattice forward and backward
(ops/rnnt_loss.py: reference_rnnt_alphas, reference_rnnt_grads, which the
CUDA kernels csrc/rnnt_fwd.cu and csrc/rnnt_bwd.cu are held to on the card)
against the JAX package's ``lax.scan`` specification and its ``jax.grad``,
and against the Pallas wavefront kernels run in interpret mode; then the
loss from joint logits and its logit gradients. Inputs come from numpy with
fixed seeds. Tolerances: the same fp32 recursion in the same order on both
sides, with XLA's and PyTorch's exp/log1p differing in the last bits over
up to T + U dependent steps, so losses within 1e-5 relative and gradients
(probabilities, at most 1) within 1e-5 absolute.
"""

import functools
import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

import efficientconformer_tpu.ops.pallas_rnnt as pr
from efficientconformer_tpu.ops.rnnt_loss import rnnt_loss as jax_rnnt_loss
from efficientconformer_tpu.ops.rnnt_loss import rnnt_loss_from_gathered as jax_from_gathered
from efficientconformer_torch.ops import rnnt_loss as RL

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5

# (B, T, U+1, f_len, y_len): ragged lengths, f_len < T, y_len = 0, y_len = U, T = 1
CASES = {
    "ragged": (4, 9, 6, [9, 7, 4, 9], [5, 3, 0, 2]),
    "t1": (3, 1, 4, [1, 1, 1], [3, 0, 1]),
    "u1": (2, 6, 1, [6, 3], [0, 0]),
}


def gathered_case(name, seed=0):
    b, t, u1, f_len, y_len = CASES[name]
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, u1, 2)).astype(np.float32) * 2
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True) + 1.5)   # blank, emit < 0
    cot = rng.uniform(0.5, 2.0, b).astype(np.float32)                  # non-trivial cotangents
    return (lp[..., 0].copy(), lp[..., 1].copy(), np.array(f_len, np.int32),
            np.array(y_len, np.int32), cot)


def port_loss_and_grads(blank, emit, f_len, y_len, cot):
    bl = torch.from_numpy(blank).requires_grad_(True)
    em = torch.from_numpy(emit).requires_grad_(True)
    loss = RL.rnnt_loss_from_gathered(bl, em, torch.from_numpy(f_len), torch.from_numpy(y_len))
    (loss * torch.from_numpy(cot)).sum().backward()
    return loss.detach().numpy(), bl.grad.numpy(), em.grad.numpy()


def jax_loss_and_grads(fn, blank, emit, f_len, y_len, cot):
    f_len, y_len, cot = jnp.asarray(f_len), jnp.asarray(y_len), jnp.asarray(cot)
    loss = fn(jnp.asarray(blank), jnp.asarray(emit), f_len, y_len)
    grads = jax.grad(lambda b_, e_: (fn(b_, e_, f_len, y_len) * cot).sum(), argnums=(0, 1))(
        jnp.asarray(blank), jnp.asarray(emit))
    return np.asarray(loss), np.asarray(grads[0]), np.asarray(grads[1])


def assert_matches(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=GRAD_TOL)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=GRAD_TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_versions_match_the_jax_scan(name):
    case = gathered_case(name)
    assert_matches(port_loss_and_grads(*case), jax_loss_and_grads(jax_from_gathered, *case))


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_versions_match_the_pallas_kernels(interpret_mode, name):
    """Loss and both gradients vs rnnt_loss_from_gathered_pallas, and the
    alphas vs the forward kernel's output, unskewed."""
    blank, emit, f_len, y_len, cot = case = gathered_case(name, seed=1)
    assert_matches(port_loss_and_grads(*case),
                   jax_loss_and_grads(pr.rnnt_loss_from_gathered_pallas, *case))
    alphas_s, _, _, (b, t, u1, *_rest) = pr._alphas(jnp.asarray(blank), jnp.asarray(emit))
    want = np.asarray(pr._unskew_t(alphas_s, t))[:b, :, :u1]
    got = RL.reference_rnnt_alphas(torch.from_numpy(blank), torch.from_numpy(emit))
    np.testing.assert_allclose(got.numpy(), want, rtol=LOSS_RTOL, atol=GRAD_TOL)


def test_gradients_are_exact_zeros_outside_each_lattice():
    blank, emit, f_len, y_len, cot = gathered_case("ragged", seed=2)
    _, g_blank, g_emit = port_loss_and_grads(blank, emit, f_len, y_len, cot)
    for i, (f, y) in enumerate(zip(f_len, y_len)):
        outside = np.ones(blank.shape[1:], bool)
        outside[:f, :y + 1] = False
        assert (g_blank[i][outside] == 0).all() and (g_emit[i][outside] == 0).all()
        assert (g_blank[i][~outside] != 0).any()
    # ll's derivative along the terminal blank is 1: d loss / d blank = -cot there
    np.testing.assert_allclose(g_blank[np.arange(4), f_len - 1, y_len], -cot, rtol=1e-5)


def logits_case(seed=0):
    rng = np.random.default_rng(seed)
    b, t, u, v = 3, 7, 4, 11
    logits = rng.standard_normal((b, t, u + 1, v)).astype(np.float32)
    labels = rng.integers(1, v, (b, u)).astype(np.int32)
    f_len, y_len = np.array([7, 5, 3], np.int32), np.array([4, 0, 2], np.int32)
    labels[1:, 3:] = 0
    return logits, labels, f_len, y_len


def test_rnnt_loss_from_logits_matches_jax():
    """Per-sample loss and the logit gradients of a weighted sum."""
    logits, labels, f_len, y_len = logits_case()
    w = np.array([1.0, 0.5, 2.0], np.float32)
    args = [jnp.asarray(a) for a in (labels, f_len, y_len)]
    want = jax_rnnt_loss(jnp.asarray(logits), *args)
    want_grad = jax.grad(lambda lg: (jax_rnnt_loss(lg, *args) * jnp.asarray(w)).sum())(
        jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_(True)
    got = RL.rnnt_loss(lg, *(torch.from_numpy(a) for a in (labels, f_len, y_len)))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(want_grad), rtol=0, atol=GRAD_TOL)
    assert (lg.grad.numpy()[1, 5:] == 0).all()                     # frames past f_len


def test_rnnt_loss_takes_bf16_logits():
    """The lattice under mixed precision: bf16 logits, the fp32 log-normaliser,
    a bf16 gradient."""
    logits, labels, f_len, y_len = logits_case(seed=3)
    lg = torch.from_numpy(logits).bfloat16().requires_grad_(True)
    got = RL.rnnt_loss(lg, *(torch.from_numpy(a) for a in (labels, f_len, y_len)))
    want = RL.rnnt_loss(lg.detach().float(), *(torch.from_numpy(a) for a in (labels, f_len,
                                                                             y_len)))
    got.sum().backward()
    assert got.dtype == torch.float32 and lg.grad.dtype == torch.bfloat16
    torch.testing.assert_close(got.detach(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("bad", [0, 11])
def test_rnnt_loss_refuses_labels_out_of_range(bad):
    logits, labels, f_len, y_len = logits_case()
    labels[2, 1] = bad
    with pytest.raises(ValueError, match="labels outside"):
        RL.rnnt_loss(*(torch.from_numpy(a) for a in (logits, labels, f_len, y_len)))
    labels[2, 1], labels[2, 3] = 1, bad                            # past y_len: ignored
    RL.rnnt_loss(*(torch.from_numpy(a) for a in (logits, labels, f_len, y_len)))


@pytest.mark.parametrize("f_len,y_len", [([0, 5, 3], [4, 0, 2]), ([7, 8, 3], [4, 0, 2]),
                                         ([7, 5, 3], [5, 0, 2])])
def test_rnnt_loss_refuses_lengths_outside_the_lattice(f_len, y_len):
    logits, labels, _, _ = logits_case()
    with pytest.raises(ValueError, match="lengths outside"):
        RL.rnnt_loss(torch.from_numpy(logits), torch.from_numpy(labels), torch.tensor(f_len),
                     torch.tensor(y_len))


def test_wrappers_have_no_path_for_other_devices():
    x = torch.empty(1, 2, 3, device="meta")
    lengths = torch.ones(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        RL.rnnt_alphas(x, x, lengths, lengths)
    with pytest.raises(ValueError, match="no kernel for device"):
        RL.rnnt_grads(x, x, x, lengths, lengths, torch.empty(1, device="meta"))


# U+1 on each side of every edge of the route table: past one thread a
# position (1,024), a strip (2,048, 4,096), a ring depth (3,584, 4,608,
# 5,632, 7,168) and the strips held in registers (8,192), and the most the
# table is held to
ROUTE_EDGES = (1024, 2048, 3584, 4096, 4608, 5632, 7168, 8192)
COVERAGE = (1025, 2048, 2049, 3584, 3585, 4096, 4097, 4608, 4609, 5632, 5633, 7168, 7169, 8192,
            8193, 65536)


def header_geometry():
    """csrc/rnnt_wavefront.cuh's constants and functions (geometry_ok,
    smem_bytes, register_strip) read as Python."""
    from test_torch_port_wide_fp32 import c_file

    return c_file("rnnt_wavefront.cuh")[0]


def assert_geometry(u1, geometry):
    """One block at U+1 = u1: whole warps whose strips cover every label
    position with no warp to spare, the fewest positions a thread (1, then
    the strips held in registers, then wider ones), the ring as deep as
    shared memory allows up to RING (none past the strips held in
    registers), and shared memory for the ring and the edge slots within
    what a block may use."""
    threads, strip, ring, smem = geometry
    assert threads % 32 == 0 and 32 <= threads <= RL.MAX_THREADS
    assert threads * strip >= u1 > (threads - 32) * strip
    held = [k for k in (1, *RL.STRIPS) if k * RL.MAX_THREADS >= u1]
    assert strip == (held[0] if held else -(-u1 // RL.MAX_THREADS))
    per_ring = 4 * 2 * strip * threads   # blank and emit of every position, one diagonal
    assert smem == 4 * RL.EDGE + ring * per_ring <= RL.SMEM_LIMIT
    if strip == 1:
        assert ring == RL.RING
    elif strip <= RL.STRIP_MAX:
        assert 1 <= ring <= RL.RING and (ring == RL.RING or smem + per_ring > RL.SMEM_LIMIT)
    else:
        assert ring == 0


@pytest.mark.parametrize("u1", [1, 32, 33, 91, 1024, *COVERAGE])
def test_launch_geometry_covers_the_lattice(u1):
    """The kernels' block at U+1 = u1 (assert_geometry); up to 1,024 one
    thread per position with the ring of RING diagonals, as the kernels have
    taken since their redesign, and the C entry points take it."""
    geometry = RL.launch_geometry(u1)
    assert_geometry(u1, geometry)
    if u1 <= RL.MAX_THREADS:
        threads = -(-u1 // 32) * 32
        assert geometry == (threads, 1, RL.RING, 4 * (RL.EDGE + RL.RING * 2 * threads))
    assert header_geometry()["geometry_ok"](u1, *geometry, 2)


@pytest.mark.parametrize("u1", [0])
def test_launch_geometry_refuses_more_label_positions_than_threads(u1):
    with pytest.raises(ValueError, match="label position"):
        RL.launch_geometry(u1)


def test_route_table_covers_every_label_length():
    """The route table over U+1 1-65,536: every geometry as
    assert_geometry asks (inlined: threads, cover, ring, shared memory),
    accepted by the header's own geometry_ok, and its edges are the
    ROUTE_EDGES that COVERAGE straddles."""
    ok = header_geometry()["geometry_ok"]
    edges, last = [], None
    for u1 in range(1, 65537):
        threads, strip, ring, smem = geometry = RL.launch_geometry(u1)
        assert threads % 32 == 0 and threads <= RL.MAX_THREADS, u1
        assert threads * strip >= u1 > (threads - 32) * strip, u1
        assert smem == 4 * (RL.EDGE + ring * 2 * strip * threads) <= RL.SMEM_LIMIT, u1
        assert (ring == RL.RING) if strip == 1 else (ring >= 1) == (strip <= RL.STRIP_MAX), u1
        assert ok(u1, *geometry, 2), u1
        if last is not None and (strip, ring) != last:
            edges.append(u1 - 1)
        last = (strip, ring)
    held = RL.STRIP_MAX * RL.MAX_THREADS
    assert tuple(e for e in edges if e <= held) == ROUTE_EDGES
    assert [e for e in edges if e > held] == list(range(held + RL.MAX_THREADS, 65536,
                                                        RL.MAX_THREADS))   # wider strips only
    assert set(COVERAGE) >= {e for e in ROUTE_EDGES if e > RL.MAX_THREADS} | {
        e + 1 for e in ROUTE_EDGES}


def test_entry_points_take_the_strips_the_wrapper_names():
    """The header's register_strip holds RL.STRIPS, and both entry points
    switch each of them to its strip kernel."""
    env = header_geometry()
    assert tuple(k for k in range(1, 65) if env["register_strip"](k)) == RL.STRIPS
    csrc = Path(RL.__file__).parents[1] / "csrc"
    for name in ("rnnt_fwd.cu", "rnnt_bwd.cu"):
        cases = re.findall(r"case (\d+): return (?:static_cast<int>\()?launch_strip<(\d+)>",
                           (csrc / name).read_text())
        assert [(int(a), int(b)) for a, b in cases] == [(k, k) for k in RL.STRIPS], name


@pytest.mark.parametrize("name,header_name", [("RING", "RING"), ("SMEM_LIMIT", "MAX_SMEM"),
                                              ("MAX_THREADS", "MAX_THREADS"),
                                              ("STRIP_MAX", "STRIP_MAX"), ("EDGE", "EDGE"),
                                              ("LOG_EPS", "LOG_EPS")])
def test_wrapper_constants_match_the_kernels_header(name, header_name):
    """The wrapper's copies of the kernels' compile-time constants agree with
    csrc/rnnt_wavefront.cuh: a ring or a limit that differs would make the C
    entry points refuse every launch, or LOG_EPS differ off the lattice."""
    header = (Path(RL.__file__).parents[1] / "csrc" / "rnnt_wavefront.cuh").read_text()
    found = re.search(rf"constexpr (?:int|float) {header_name} = ([^;]+);", header)
    assert found, header_name
    assert float(eval(found.group(1).rstrip("f"))) == getattr(RL, name)   # "2 * 32", "-1e30f"
