"""PyTorch port vs the JAX package: the RNN-T loss past 1,024 label
positions, on the CPU in fp32.

The kernels take any U+1 since their strip routes (ops/rnnt_loss.py
launch_geometry; the card holds them to the plain versions in
tests/test_torch_port_cuda.py and chip_smoke.py's [rnnt-long-kernel]). Here
the plain versions (reference_rnnt_alphas, reference_rnnt_grads) are held
to the JAX package at U+1 1,025 and 1,100, ragged lengths with y_len = U
and y_len = 0, inputs from numpy with fixed seeds:

- to the Pallas wavefront kernels in interpret mode, the TPU kernels the
  CUDA ones replace, which run the same log-space recursions: losses within
  1e-5 relative and gradients within 1e-5 absolute (they agree to ~6e-8);
- to the ``lax.scan`` specification: losses within 1e-5 relative (equal
  here). Its gradients come from ``jax.grad`` through the scan, a product
  of local weights in linear space rather than log-space betas, and at
  these lengths |ll| reaches ~1,800, where an fp32 ulp is 1.2e-4: every fp32
  implementation's gradient lies 2e-4 to 6e-3 from float64, the JAX
  package's scan, its Pallas kernels and the port's alike, so 1e-5 between
  two of them is out of fp32's reach. A gradient is exp(alpha + lp + beta -
  ll), and alpha, beta and ll each carry the rounding of a walk of f + y
  steps at |ll|'s ulp, so the gradients of an utterance are held within
  1e-5 + cot * 2^-24 * |ll| * sqrt(f + y) of the scan's (``fp32_walk``: the
  errors read 0.09-0.54 of that bound, and at |ll| ~ 15 the bound is 1e-5),
  and the port's and the fp32 scan's each within that of the scan's own
  float64 run (``jax.enable_x64``).

Then the evaluation loss of a narrow Transducer (3 blocks, widths <= 32,
64 tokens, fp32) on one utterance carrying 1,100 labels, the port's
``Trainer.eval_loss`` against the JAX package's ``eval_loss_fn`` on the
same weights (the port's, mapped by the JAX package's
utils/torch_compat.convert_transducer), within 1e-5 relative.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

import efficientconformer_tpu.ops.pallas_rnnt as pr
from efficientconformer_tpu.config import from_dict
from efficientconformer_tpu.ops.rnnt_loss import rnnt_loss_from_gathered as jax_from_gathered
from efficientconformer_tpu.training.trainer import Trainer as JaxTrainer
from efficientconformer_tpu.training.trainer import TrainerState
from efficientconformer_tpu.utils import torch_compat as TC
from efficientconformer_torch.ops import rnnt_loss as RL
from efficientconformer_torch.training.trainer import Trainer
from test_torch_port_rnnt import jax_loss_and_grads, port_loss_and_grads
from test_torch_port_transducer import narrow_transducer

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5

# (B, T, U+1, f_len, y_len): past one thread a label position, the first
# strip (1,025) and the evaluation slice's lattice width (1,100)
CASES = {
    "1025": (3, 9, 1025, [9, 7, 4], [1024, 500, 0]),
    "1100": (2, 12, 1100, [12, 6], [1099, 0]),
}


@functools.lru_cache(maxsize=None)
def gathered_case(name):
    """Blank and emit log-probs of a two-way softmax with 1.5 of mass left
    over, as test_torch_port_rnnt's cases; cotangents in [0.5, 2]."""
    b, t, u1, f_len, y_len = CASES[name]
    rng = np.random.default_rng(u1)
    logits = rng.standard_normal((b, t, u1, 2)).astype(np.float32) * 2
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True) + 1.5)
    cot = rng.uniform(0.5, 2.0, b).astype(np.float32)
    return (lp[..., 0].copy(), lp[..., 1].copy(), np.array(f_len, np.int32),
            np.array(y_len, np.int32), cot)


@functools.lru_cache(maxsize=None)
def port(name):
    return port_loss_and_grads(*gathered_case(name))


@functools.lru_cache(maxsize=None)
def scan(name, x64=False):
    case = gathered_case(name)
    if not x64:
        return jax_loss_and_grads(jax_from_gathered, *case)
    with jax.enable_x64(True):
        return jax_loss_and_grads(jax_from_gathered, *(
            x.astype(np.float64) if x.dtype == np.float32 else x for x in case))


@functools.lru_cache(maxsize=None)
def pallas(name):
    """Loss, both gradients and the forward kernel's alphas (unskewed) of
    the Pallas kernels in interpret mode."""
    blank, emit, *_ = case = gathered_case(name)
    interpret = functools.partial(pl.pallas_call, interpret=True)
    original, pl.pallas_call = pl.pallas_call, interpret
    try:
        out = jax_loss_and_grads(pr.rnnt_loss_from_gathered_pallas, *case)
        alphas_s, _, _, (b, t, u1, *_rest) = pr._alphas(jnp.asarray(blank), jnp.asarray(emit))
    finally:
        pl.pallas_call = original
    return (*out, np.asarray(pr._unskew_t(alphas_s, t))[:b, :, :u1])


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_versions_match_the_pallas_kernels_past_1024(name):
    """Loss and both gradients vs rnnt_loss_from_gathered_pallas, and the
    alphas vs its forward kernel's."""
    got, want = port(name), pallas(name)
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=GRAD_TOL)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=GRAD_TOL)
    blank, emit, *_ = gathered_case(name)
    alphas = RL.reference_rnnt_alphas(torch.from_numpy(blank), torch.from_numpy(emit))
    np.testing.assert_allclose(alphas.numpy(), want[3], rtol=LOSS_RTOL, atol=GRAD_TOL)


def fp32_walk(name, exact_loss):
    """(B, 1, 1): the gradient tolerance of each utterance (docstring)."""
    _, _, f_len, y_len, cot = gathered_case(name)
    walk = cot * 2.0 ** -24 * np.abs(exact_loss) * np.sqrt(f_len + y_len)
    return (GRAD_TOL + walk)[:, None, None]


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_versions_match_the_jax_scan_past_1024(name):
    """The loss vs the scan within 1e-5; the gradients within the fp32
    walk of each utterance (docstring) of the scan's, and the port's and the
    scan's within it of the scan's float64 run."""
    got, want, exact = port(name), scan(name), scan(name, x64=True)
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[0], exact[0], rtol=LOSS_RTOL)
    tol = fp32_walk(name, exact[0])
    for i in (1, 2):
        for a, b in ((got, want), (got, exact), (want, exact)):
            assert (np.abs(a[i] - b[i]) <= tol).all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradients_are_exact_zeros_outside_each_lattice_past_1024(name):
    _, g_blank, g_emit = port(name)
    _, _, f_len, y_len, cot = gathered_case(name)
    for i, (f, y) in enumerate(zip(f_len, y_len)):
        outside = np.ones(g_blank.shape[1:], bool)
        outside[:f, :y + 1] = False
        assert (g_blank[i][outside] == 0).all() and (g_emit[i][outside] == 0).all()
    # ll's derivative along the terminal blank is 1: d loss / d blank = -cot there
    np.testing.assert_allclose(g_blank[np.arange(len(f_len)), f_len - 1, y_len], -cot,
                               rtol=1e-5)


def long_form_config() -> dict:
    """narrow_transducer cut to 3 blocks (one a stage, G 3 in the first),
    widths 16 / 24 / 32, a 32-wide prediction network and joint over 64
    tokens, fp32."""
    cfg = narrow_transducer()
    cfg["encoder_params"].update(num_blocks=3, dim_model=[16, 24, 32], strided_blocks=[0, 1],
                                 expand_blocks=[0, 1])
    cfg["decoder_params"].update(dim_model=32, vocab_size=64)
    cfg["joint_params"].update(dim_model=32)
    cfg["tokenizer_params"]["vocab_size"] = 64
    cfg["training_params"]["mixed_precision"] = False
    return cfg


def test_eval_loss_matches_jax_past_1024():
    """One 1.2 s utterance (16 encoder frames) carrying 1,100 labels (U+1
    1,101): the port's Trainer.eval_loss against the JAX package's
    eval_loss_fn on the same weights; the lattice goes through the strip
    route's geometry (on the CPU, its plain version)."""
    cfg = long_form_config()
    trainer = Trainer(cfg, device="cpu", seed=5)
    params, stats = TC.convert_transducer(trainer.model.state_dict())
    state = TrainerState(params=jax.tree.map(jnp.asarray, params),
                         batch_stats=jax.tree.map(jnp.asarray, stats), opt_state=None,
                         step=jnp.zeros((), jnp.int32))
    rng = np.random.default_rng(7)
    n, u = 19200, 1100
    batch = {"audio": (rng.standard_normal((1, n)) * 0.1).astype(np.float32),
             "audio_len": np.array([n], np.int32),
             "labels": rng.integers(1, 64, (1, u)).astype(np.int32),
             "label_len": np.array([u], np.int32)}
    want = float(JaxTrainer(from_dict(cfg)).eval_loss_fn()(
        state, {k: jnp.asarray(v) for k, v in batch.items()}))
    seen = []
    real = RL.rnnt_loss_from_gathered

    def spy(blank_lp, emit_lp, f_len, y_len):
        seen.append(tuple(blank_lp.shape))
        return real(blank_lp, emit_lp, f_len, y_len)

    RL.rnnt_loss_from_gathered = spy
    try:
        got = float(trainer.eval_loss(batch))
    finally:
        RL.rnnt_loss_from_gathered = real
    assert seen == [(1, 16, u + 1)] and RL.launch_geometry(u + 1)[1] == 2   # the first strip
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
