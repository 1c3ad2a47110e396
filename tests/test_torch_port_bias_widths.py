"""The bias attention at every head width, on the CPU.

The wrapper's route table (ops/bias_attention.py: ``route``) is computed in
Python from the kernel files' constants; it is held here to those
constants, and to the kernel files' own route and size functions read as
Python (tests/test_torch_port_wide_fp32.py: ``c_file``), at every dqk = dv
from 1 to 4,096 and a grid of unequal pairs, in both types and directions,
at one query row (the LM's KV-cache step) and longer, against one key and
more than a thousand. Nothing is refused for width.

Then the plain versions, which the chunked kernels past a width of 256 are
held to on the card (tests/test_torch_port_cuda.py, chip_smoke.py's
[widest-kernel]), against the TPU kernels of
efficientconformer_tpu/ops/pallas_attention.py in interpret mode at widths
270, 384 and 512, dqk != dv among them, with the tolerances of
tests/test_torch_port_bias_attention.py. Last, the path that sends those
widths to the kernels: EfficientConformer CTC Large at 4 heads made causal
(its stage 1's grouped head is 3 x 360 / 4 = 270, on the skewing path onto
the bias attention), one block a stage, against the JAX package in fp32:
eval-mode logits, the loss and gradients, and one Trainer step from the
same non-zero Adam state.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import efficientconformer_tpu.ops.pallas_attention as pa
from efficientconformer_tpu.models.model_ctc import ModelCTC as JaxModelCTC
from efficientconformer_tpu.ops.ctc_loss import ctc_loss as jax_ctc_loss
from efficientconformer_torch.config import resolve_block_configs
from efficientconformer_torch.models.model_ctc import ModelCTC
from efficientconformer_torch.ops import bias_attention as BA
from efficientconformer_torch.ops.ctc_loss import ctc_loss
from efficientconformer_torch.utils import weights as W
from test_torch_port_bias_attention import (NEG_INF, assert_grad_close, f32, interpret_mode,  # noqa: F401
                                            jax_inputs, lse_tol, o_tol, port_forward, port_grads)
from test_torch_port_training import LOSS_RTOL, PARAM_TOL, run_both
from test_torch_port_variants import assert_grads_close, jit_init, perturbed
from test_torch_port_wide_fp32 import (CSRC, GRAD_TOL, LOGITS_TOL, ROOT, VOCAB, c_file,
                                       encoder_params)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ------------------------------------------------------------- route table


def kernels(name: str) -> dict:
    return c_file(name)[0]


@pytest.mark.parametrize("name,source,key", [
    ("SMEM_LIMIT", "bias_attention_fwd.cu", "MAX_SMEM"),
    ("SMEM_LIMIT", "bias_attention_bwd.cu", "MAX_SMEM"),
    ("WHOLE_WIDTH", "bias_attention_fwd.cu", "WHOLE_WIDTH"),
    ("WHOLE_WIDTH", "bias_attention_bwd.cu", "WHOLE_WIDTH"),
    ("FMA_BQ", "bias_attention_fwd.cu", "BQ"), ("FMA_BQ", "bias_attention_fwd.cu", "BK"),
    ("FMA_BQ", "bias_attention_bwd.cu", "BQ"), ("FMA_BQ", "bias_attention_bwd.cu", "BK"),
    ("FMA_LDQ", "bias_attention_fwd.cu", "LDQ"), ("FMA_LDK", "bias_attention_fwd.cu", "LDK"),
    ("FMA_LDP", "bias_attention_fwd.cu", "LDP"), ("FMA_LDV", "bias_attention_bwd.cu", "LDV"),
    ("FMA_LDS", "bias_attention_bwd.cu", "LDS"), ("FMA_WIDE_ROWS", "bias_attention_bwd.cu", "WB"),
    ("FC_TILE", "bias_fma.cuh", "T"), ("FC_KC", "bias_fma.cuh", "KC"),
    ("FC_STAGES", "bias_fma.cuh", "STAGES"), ("FC_LDT", "bias_fma.cuh", "LDT"),
    ("FC_LDX", "bias_fma.cuh", "LDX"),
    ("TC_BQ", "bias_attention_fwd.cu", "TC_BQ"), ("TC_BK", "bias_attention_fwd.cu", "TC_BK"),
    ("TC_LDB", "bias_attention_fwd.cu", "TC_LDB"),
    ("TC_STAGES", "bias_attention_fwd.cu", "TC_STAGES"),
    ("TC_STAGES", "bias_attention_bwd.cu", "TC_STAGES"),
    ("TC_BLOCK", "bias_attention_bwd.cu", "TC_BLOCK"),
    ("TC_TILE", "bias_attention_bwd.cu", "TC_TILE"),
    ("TC_LDQ", "bias_attention_bwd.cu", "TC_LDQ"), ("TC_LDK", "bias_attention_bwd.cu", "TC_LDK"),
    ("FU_N", "bias_attention_bwd.cu", "FU_N"), ("FU_D", "bias_attention_bwd.cu", "FU_D"),
    ("FU_LD", "bias_attention_bwd.cu", "FU_LD"), ("FU_LDC", "bias_attention_bwd.cu", "FU_LDC"),
    ("CK_KC", "bias_attention_fwd.cu", "CK_KC"), ("CK_KC", "bias_attention_bwd.cu", "CK_KC"),
    ("CK_LDC", "bias_attention_fwd.cu", "CK_LDC"), ("CK_LDC", "bias_attention_bwd.cu", "CK_LDC"),
    ("CK_DOUT", "bias_attention_fwd.cu", "CK_DOUT"),
    ("CK_DOUT", "bias_attention_bwd.cu", "CK_DOUT"),
    ("CK_LDG", "bias_attention_fwd.cu", "CK_LDG"), ("CK_LDG", "bias_attention_bwd.cu", "CK_LDG"),
    ("CK_STAGES", "bias_attention_fwd.cu", "CK_STAGES"),
    ("CK_STAGES", "bias_attention_bwd.cu", "CK_STAGES"),
])
def test_wrapper_constants_match_the_kernels(name, source, key):
    """The wrapper's copies of the bias kernels' compile-time constants
    agree with csrc/: a stride or a limit that differs would size the route
    table for another kernel than the one that runs."""
    assert kernels(source)[key] == getattr(BA, name)


@pytest.mark.parametrize("source,fn,table", [
    ("bias_attention_fwd.cu", "jmax_for", "FMA_COLUMNS"),
    ("bias_attention_bwd.cu", "jmax_for", "FMA_BWD_COLUMNS"),
    ("bias_attention_bwd.cu", "jw_for", "FMA_WIDE_COLUMNS"),
])
def test_wrapper_column_tables_match_the_kernels(source, fn, table):
    """The feature columns a thread owns, as the FMA kernels pick them, at
    every width they take (the forward's and the backward's up to
    WHOLE_WIDTH, the wide backward's from 129), against the wrapper's
    tables; and the tensor-core kernels' padded widths."""
    pick = kernels(source)[fn]
    lo = 129 if fn == "jw_for" else 1
    for d in range(lo, BA.WHOLE_WIDTH + 1):
        assert pick(d) == BA._columns(d, getattr(BA, table)), (fn, d)
    for source in ("bias_attention_fwd.cu", "bias_attention_bwd.cu"):
        dmax = kernels(source)["tc_dmax"]
        for dqk, dv in ((1, 1), (64, 8), (65, 8), (8, 144), (145, 8), (256, 256), (264, 8)):
            assert dmax(dqk, dv) == BA.tc_dmax(dqk, dv) == min(
                d for d in BA.TC_DMAX if d >= min(BA.tc_width(dqk, dv), BA.WHOLE_WIDTH))


ROWS = (1, 64, 201)            # query rows: the LM's KV-cache step, a tile, past three
KEYS = (1, 100, 1025)          # keys: one, the LM's, past a thousand
WIDTHS = range(1, 4097)        # dqk = dv
PAIRS = [(a, b) for a in (1, 8, 24, 64, 90, 135, 136, 144, 200, 256, 257, 264, 270, 384, 512,
                          1024, 4096)
         for b in (1, 64, 135, 256, 257, 270, 512, 2048) if a != b]


def assert_route_is_the_kernels(dtype, nq, nk, dqk, dv, backward):
    """The wrapper's route for these sizes: the kernel files' own choice
    (ecf_bias_attention_{fwd,bwd}_route read as Python), sizes
    (ecf_bias_attention_fwd_smem, _fwd_out_smem, _bwd_q_smem, _bwd_k_smem),
    each within the shared memory a block may use, and scratch
    (ecf_bias_attention_{fwd,bwd}_work against ``work_floats``). The
    kernels see bf16 widths padded to a multiple of 8 (_pad8); the route is
    the same at either."""
    code = BA._DTYPE_CODE[dtype]
    got = BA.route(dtype, nq, nk, dqk, dv, backward)
    work = BA.work_floats(dtype, nq, nk, dqk, dv, backward)
    if dtype == torch.bfloat16:
        dqk, dv = -(-dqk // 8) * 8, -(-dv // 8) * 8
    if backward:
        env = kernels("bias_attention_bwd.cu")
        args = (code, nq, nk, dqk, dv)
        name = BA.ROUTES_BWD[env["ecf_bias_attention_bwd_route"](*args)]
        sizes = tuple(b for b in (env["ecf_bias_attention_bwd_q_smem"](*args),
                                  env["ecf_bias_attention_bwd_k_smem"](*args)) if b)
        assert work == env["ecf_bias_attention_bwd_work"](*args)
    else:
        env = kernels("bias_attention_fwd.cu")
        name = BA.ROUTES_FWD[env["ecf_bias_attention_fwd_route"](code, dqk, dv)]
        sizes = tuple(b for b in (env["ecf_bias_attention_fwd_smem"](code, dqk, dv),
                                  env["ecf_bias_attention_fwd_out_smem"](code, dqk, dv)) if b)
        assert work == env["ecf_bias_attention_fwd_work"](code, nq, nk, dqk, dv)
    assert (got.name, tuple(b for _, b in got.kernels)) == (name, sizes), \
        (dtype, nq, nk, dqk, dv, backward)
    assert 0 < max(sizes) <= BA.SMEM_LIMIT, (dtype, nq, nk, dqk, dv, backward, sizes)
    chunked = max(-(-dqk // 16) * 16, -(-dv // 16) * 16) > BA.WHOLE_WIDTH \
        if dtype == torch.bfloat16 else max(dqk, dv) > BA.WHOLE_WIDTH
    assert got.name.endswith("_chunked") == chunked
    return got


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_every_width_has_a_route_within_shared_memory(dtype, backward):
    """Every dqk = dv from 1 to 4,096, at 1, 64 and 201 query rows against
    1, 100 and 1,025 keys: a route the kernel files agree on, within the
    232,448 bytes a block may use; past 256 the chunked kernels, whose
    shared memory does not grow with the width."""
    t = DTYPES[dtype]
    names = set()
    for d in WIDTHS:
        for nq in ROWS:
            for nk in KEYS:
                names.add(assert_route_is_the_kernels(t, nq, nk, d, d, backward).name)
    chunked = BA.route(t, 1, 1, 4096, 4096, backward)
    assert chunked == BA.route(t, 201, 1025, 257 if t == torch.float32 else 264, 257, backward)
    want = {(False, False): {"fma", "fma_chunked"}, (False, True): {"fma", "fma_wide", "fma_chunked"},
            (True, False): {"tc", "tc_chunked"}, (True, True): {"fused", "tc", "tc_chunked"}}
    assert names == want[(t == torch.bfloat16, backward)]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_unequal_widths_have_a_route_within_shared_memory(dtype):
    """dqk != dv, either one past 256 or both, in both directions at the
    same rows and keys: the route follows the wider of the two."""
    t = DTYPES[dtype]
    for dqk, dv in PAIRS:
        for nq in ROWS:
            for nk in KEYS:
                for backward in (False, True):
                    assert_route_is_the_kernels(t, nq, nk, dqk, dv, backward)


def test_nothing_is_refused_for_width():
    """No width limit is left in the wrapper or the kernel files: the
    wrapper's checks take a width of 4,096 and an unequal pair, and the
    launches' widths go to the route table alone."""
    assert not hasattr(BA, "MAX_WIDTH")
    for name in ("bias_attention_fwd.cu", "bias_attention_bwd.cu"):
        assert "MAX_WIDTH" not in (CSRC / name).read_text()
    for dqk, dv in ((4096, 4096), (270, 135), (64, 512), (512, 64)):
        q, k = torch.zeros(1, 2, 3, dqk), torch.zeros(1, 2, 5, dqk)
        v, bias = torch.zeros(1, 2, 5, dv), torch.zeros(1, 1, 1, 5)
        assert BA._checked_inputs(q, k, v, bias)[0] is bias
        assert BA._checked_inputs(q.bfloat16(), k.bfloat16(), v.bfloat16(), None)[0] is None


def fp32_tiles_forward(q, k, v, bias, scale):
    """The fp32 chunked forward's arithmetic in torch, tile by tile as
    csrc/bias_attention_fwd.cu's two kernels run it: per (query tile, key
    tile) S once, its rows' max m over the tile's keys (-inf when they all
    score -inf) and E = exp(S - m) with its sum l; then per row M, the max
    of the m, L = sum of l exp(m - M) in key-tile order, O = sum over the
    key tiles of exp(m - M) / L (E v), LSE = M + log L in fp64."""
    t = BA.FC_TILE
    nq, nk = q.shape[2], k.shape[2]
    s = q @ k.transpose(-1, -2) * scale + (0.0 if bias is None else bias)
    tiles = [s[..., k0:k0 + t] for k0 in range(0, nk, t)]
    ms = [x.amax(-1, keepdim=True) for x in tiles]
    es = [torch.exp(x - torch.where(m == -torch.inf, 0.0, m)) for x, m in zip(tiles, ms)]
    big = torch.stack(ms).amax(0)
    total = sum(e.sum(-1, keepdim=True) * torch.exp(m - big) for e, m in zip(es, ms))
    o = sum(torch.exp(m - big) / total * (e @ v[..., k0:k0 + t, :])
            for e, m, k0 in zip(es, ms, range(0, nk, t)))
    assert o.shape == (*q.shape[:3], v.shape[-1]) and nq == q.shape[2]
    return o, big[..., 0].double() + total[..., 0].double().log()


def fp32_tiles_backward(q, k, v, bias, do, scale):
    """The fp32 chunked backward's arithmetic as csrc/bias_attention_bwd.cu's
    two kernels run it: P = exp(S - LSE) (fp64 difference) and dS = P (dP -
    Di) once per tile pair, Di = rowsum(dO * O); then dq = scale dS k, dk =
    scale dS^T q, dv = P^T dO from those tiles."""
    o, lse = fp32_tiles_forward(q, k, v, bias, scale)
    s = q @ k.transpose(-1, -2) * scale + (0.0 if bias is None else bias)
    p = torch.exp((s.double() - lse[..., None]).float())
    ds = p * (do @ v.transpose(-1, -2) - (do * o).sum(-1, keepdim=True))
    return (scale * ds @ k, scale * ds.transpose(-1, -2) @ q, p.transpose(-1, -2) @ do, ds)


@pytest.mark.parametrize("name", ["w270", "w270-135", "w384-keymask", "w512-64-head"])
def test_fp32_chunked_tile_arithmetic_matches_the_plain_version(name):
    """The tile decomposition of the fp32 chunked kernels (scores once per
    64 x 64 tile pair, the rows' statistics folded across key tiles, the
    gradients from the score tiles) against the plain versions, fp32 1e-5:
    at 130 keys (three key tiles, the last ragged), a row whose real keys
    all carry the -1e9 mask (it averages v), and one query row."""
    q, k, v, bias, scale = (torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                            for a in wide_inputs(name))
    rng = np.random.default_rng(5)
    b, h, nq, dqk = q.shape
    for nk in (130, 1):
        keys = torch.as_tensor(rng.standard_normal((b, h, nk, dqk)).astype(np.float32))
        vals = torch.as_tensor(rng.standard_normal((b, h, nk, v.shape[-1])).astype(np.float32))
        mask = torch.as_tensor(rng.standard_normal((b, 1, nq, nk)).astype(np.float32))
        mask[:, :, 1] = NEG_INF
        for rows in (nq, 1):
            args = (q[:, :, :rows], keys, vals, mask[:, :, :rows], scale)
            got, want = fp32_tiles_forward(*args), BA.reference_bias_attention(*args)
            torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-5)
            torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)
            do = torch.as_tensor(rng.standard_normal(got[0].shape).astype(np.float32))
            for g, w in zip(fp32_tiles_backward(*args[:4], do, scale),
                            BA.reference_bias_attention_bwd(*args[:4], do, scale)):
                torch.testing.assert_close(g, w, rtol=0, atol=1e-5)


# ------------------------------------------ the plain versions past 256, vs JAX

# (B, H, Nq, Nk, dqk, dv, bias layout) at widths past the kernels that hold a
# row whole: the causal 4-head Large's grouped head 270, and 384 and 512,
# dqk != dv among them
WIDE_CASES = {
    "w270": (1, 2, 9, 13, 270, 270, "bhqk"),
    "w270-135": (1, 2, 11, 7, 270, 135, "bhqk"),
    "w384-keymask": (2, 1, 7, 11, 384, 384, "b11k"),
    "w512-64-head": (2, 2, 5, 9, 512, 64, "1hqk"),
    "w64-512-keymask": (1, 2, 6, 10, 64, 512, "b11k"),
}


def wide_inputs(name, seed=0):
    """numpy (q, k, v, bias, scale): random scores with ragged key lengths
    as -1e9 columns, as tests/test_torch_port_bias_attention.py makes them."""
    b, h, nq, nk, dqk, dv, layout = WIDE_CASES[name]
    rng = np.random.default_rng(seed)
    shape = tuple({"b": b, "h": h, "q": nq, "k": nk, "1": 1}[c] for c in layout)
    bias = (rng.standard_normal(shape) * 0.5).astype(np.float32) if layout[2] == "q" \
        else np.zeros(shape, np.float32)
    lengths = np.linspace(nk // 2, nk, shape[0]).astype(int)
    bias = np.where(np.arange(nk) >= lengths[:, None, None, None], NEG_INF, bias)
    q = rng.standard_normal((b, h, nq, dqk)).astype(np.float32)
    k = rng.standard_normal((b, h, nk, dqk)).astype(np.float32)
    v = rng.standard_normal((b, h, nk, dv)).astype(np.float32)
    return q, k, v, bias.astype(np.float32), 1.0 / np.sqrt(dqk)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(WIDE_CASES))
def test_wide_forward_matches_both_pallas_kernels(interpret_mode, name, dtype):
    """O and LSE against _fused_forward (one block a (b, h)) and
    _flash_forward (keys tiled, the online softmax), both padding dqk and
    dv to 128 lanes."""
    q, k, v, bias, scale = wide_inputs(name)
    o, lse = port_forward(q, k, v, bias, scale, dtype)
    for kernel in (pa._fused_forward, pa._flash_forward):
        want_o, want_lse = kernel(*jax_inputs(q, k, v, bias, dtype), scale)
        np.testing.assert_allclose(o, f32(want_o), rtol=0, atol=o_tol(dtype))
        np.testing.assert_allclose(lse, np.asarray(want_lse), rtol=lse_tol(dtype),
                                   atol=lse_tol(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(WIDE_CASES))
def test_wide_backward_matches_fused_bwd(interpret_mode, name, dtype):
    """dq, dk, dv and the bias gradient (dS summed over the bias's broadcast
    axes) against jax.vjp through fused_bias_attention, whose _fused_bwd
    recomputes in XLA."""
    q, k, v, bias, scale = wide_inputs(name, seed=1)
    do = np.random.default_rng(2).standard_normal(q.shape[:3] + v.shape[-1:]).astype(np.float32)
    got = port_grads(q, k, v, bias, scale, do, dtype=dtype)
    _, vjp = jax.vjp(lambda *a: pa.fused_bias_attention(*a, scale),
                     *jax_inputs(q, k, v, bias, dtype))
    want = vjp(jnp.asarray(do, dtype=getattr(jnp, dtype)))
    assert got[3].shape == bias.shape
    for label, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert_grad_close(g, w, dtype, label)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", ["w384-keymask", "w64-512-keymask"])
def test_wide_backward_matches_the_tiled_pallas_backward(interpret_mode, monkeypatch, name,
                                                         dtype):
    """With dS asked for (the bias requires a gradient): dq, dk and dv
    against _flash_backward (the two tiled Pallas passes, forced with
    PALLAS_BWD) and the bias gradient against _fused_bwd's dS, summed over
    the key mask's broadcast axes."""
    q, k, v, bias, scale = wide_inputs(name, seed=3)
    do = np.random.default_rng(4).standard_normal(q.shape[:3] + v.shape[-1:]).astype(np.float32)
    got = port_grads(q, k, v, bias, scale, do, bias_grad=True, dtype=dtype)
    jargs = jax_inputs(q, k, v, bias, dtype)
    jdo = jnp.asarray(do, dtype=getattr(jnp, dtype))
    _, vjp = jax.vjp(lambda *a: pa.fused_bias_attention(*a, scale), *jargs)
    want_dbias = vjp(jdo)[3]
    monkeypatch.setattr(pa, "PALLAS_BWD", True)
    o, lse = pa._dispatch_forward(*jargs, scale, with_lse=True)
    want = pa._flash_backward(*jargs, o, lse, jdo, scale)
    for label, g, w in zip(("dq", "dk", "dv", "dbias"), got, (*want, want_dbias)):
        assert_grad_close(g, w, dtype, label)


# ------------------------------------ the causal 4-head Large, vs JAX in fp32

STREAM_LEFT = 64   # chip_smoke.py's left context of a causal encoder on a serving window


def causal_heads4() -> dict:
    """EfficientConformer CTC Large at 4 heads made causal, one block a
    stage (the stride and the expansion after blocks 0 and 1), dropout 0
    and SpecAugment off: heads 270 / 128 / 180, every attention layer on
    the skewing path onto the bias attention."""
    return encoder_params("EfficientConformerCTCLarge", num_heads=4, causal=True,
                          left_context=STREAM_LEFT, num_blocks=3, strided_blocks=[0, 1],
                          expand_blocks=[0, 1])


@pytest.fixture
def counted_bias(monkeypatch):
    """Calls of the bias attention's plain versions (the wrapper's CPU
    path), by the (dqk, dv) of each."""
    calls = {"fwd": [], "bwd": []}
    for name, key in (("reference_bias_attention", "fwd"),
                      ("reference_bias_attention_bwd", "bwd")):
        def counted(*args, _fn=getattr(BA, name), _key=key):
            calls[_key].append((args[0].shape[-1], args[2].shape[-1]))
            return _fn(*args)
        monkeypatch.setattr(BA, name, counted)
    return calls


def test_causal_heads4_encoder_matches_jax_in_fp32(counted_bias):
    """Eval-mode logits and lengths, then the mean CTC loss in train mode and
    its gradients, against jax.grad of the same loss from the same weights
    (utils/weights.from_jax): stage 1's head 270 goes through the bias
    attention both ways (its plain versions on the CPU, counted)."""
    enc = causal_heads4()
    assert sorted({b.att_group_size * b.dim_model // b.num_heads
                   for b in resolve_block_configs(enc)}) == [128, 180, 270]
    jax_model = JaxModelCTC(encoder_params=enc, vocab_size=VOCAB)
    rng = np.random.default_rng(20)
    n = np.array([12000, 8800])
    x = (rng.standard_normal((2, n.max())) * 0.1).astype(np.float32)
    x[1, n[1]:] = 0.0
    x_len = n.astype(np.int32)
    labels = rng.integers(1, VOCAB, (2, 5)).astype(np.int32)
    y_len = np.array([5, 3], np.int32)
    variables = perturbed(jit_init(jax_model, 7, x, x_len), 8)
    port = ModelCTC(enc, VOCAB)
    port.load_state_dict(W.from_jax(variables), strict=True)

    @jax.jit
    def both(params):
        logits, f_len, _ = jax_model.apply({**variables, "params": params}, x, x_len, False)

        def loss(params):
            (out, lens, _), _ = jax_model.apply({**variables, "params": params}, x, x_len, True,
                                                mutable=["batch_stats"])
            return jnp.mean(jax_ctc_loss(jax.nn.log_softmax(out, -1), labels, lens, y_len))

        return logits, f_len, jax.value_and_grad(loss)(params)

    want, want_len, (want_loss, grads) = both(variables["params"])
    with torch.no_grad():
        got, got_len = port.eval()(torch.from_numpy(x), torch.from_numpy(x_len))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    for i, t in enumerate(got_len.tolist()):
        np.testing.assert_allclose(got[i, :t].numpy(), np.asarray(want)[i, :t], rtol=0,
                                   atol=LOGITS_TOL)
    assert counted_bias["fwd"] == [(270, 270), (128, 128), (180, 180)]

    port.train()
    logits, f_len = port(torch.from_numpy(x), torch.from_numpy(x_len), torch.Generator())
    loss = ctc_loss(torch.log_softmax(logits, -1), torch.from_numpy(labels).long(), f_len,
                    torch.from_numpy(y_len).long()).mean()
    loss.backward()
    assert counted_bias["bwd"] == [(180, 180), (128, 128), (270, 270)]
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    want_grads = W.params_from_jax(grads)
    assert_grads_close({k: p.grad if p.grad is not None else torch.zeros_like(p)
                        for k, p in port.named_parameters()},
                       {k: want_grads[k] for k, _ in port.named_parameters()}, tol=GRAD_TOL)


def test_causal_heads4_train_step_matches_jax(counted_bias):
    """One accumulated Trainer step (2 microbatches of 3 ragged utterances)
    of the causal 4-head Large against the JAX package's train step from
    the same weights and the same non-zero Adam state: the loss, the
    reported gradient norm and every updated parameter
    (test_torch_port_training.py's gates). The gradients themselves are held
    in the test above. The norm sums the gradients' squares in float64: an
    fp32 sum read 1.2e-4 low here, on the 360 x 14,400 input projection's
    gradient and the million-entry FFN and conv weights'."""
    cfg = json.loads((ROOT / "configs" / "EfficientConformerCTCLarge.json").read_text())
    cfg["encoder_params"] = causal_heads4()
    cfg["tokenizer_params"]["vocab_size"] = 16
    cfg["training_params"].update({"mixed_precision": False, "warmup_steps": 20})
    port, (loss, grad_norm), _, new, metrics = run_both(cfg, adam_count=10)
    np.testing.assert_allclose(float(loss), float(metrics["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(grad_norm), float(metrics["grad_norm"]), rtol=LOSS_RTOL)
    want = W.params_from_jax(jax.tree.map(np.asarray, new.params))
    for name, p in port.model.named_parameters():
        torch.testing.assert_close(p.detach(), want[name], rtol=0, atol=PARAM_TOL, msg=name)
    assert counted_bias["fwd"].count((270, 270)) == 2 and counted_bias["bwd"].count((270, 270)) == 2
