"""PyTorch port vs the JAX package: log-mel frontend, masks, head/group
layouts and the factorized rel-pos tables and weight folds, on the CPU.

The same numpy inputs go through both; the port's tensors come back as numpy.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from efficientconformer_tpu.ops import attention as JA
from efficientconformer_tpu.ops import masks as JM
from efficientconformer_tpu.ops import rel_factorize as JRF
from efficientconformer_tpu.ops.audio import log_mel_spectrogram as jax_log_mel
from efficientconformer_torch.ops import attention as TA
from efficientconformer_torch.ops import masks as TM
from efficientconformer_torch.ops import rel_factorize as TRF
from efficientconformer_torch.ops.audio import log_mel_spectrogram as torch_log_mel

EXACT = 1e-6   # same fp32 arithmetic, at most a rounding apart


def rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def assert_close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("b,t", [(2, 16385), (3, 8000)])
def test_log_mel_matches_jax(b, t):
    rng = np.random.default_rng(t)
    x = (rng.standard_normal((b, t)) * 0.1).astype(np.float32)
    x_len = np.linspace(t // 2, t, b).astype(np.int32)
    for i in range(b):
        x[i, x_len[i]:] = 0.0
    want, want_len = jax_log_mel(jnp.asarray(x), jnp.asarray(x_len))
    got, got_len = torch_log_mel(torch.from_numpy(x), torch.from_numpy(x_len))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert_close(got, want, 1e-3)   # the bound of tests/test_torch_parity.py


def test_log_mel_stays_fp32_for_bf16_audio():
    x = torch.from_numpy(rand(1, 4000, seed=3, scale=0.1))
    got, _ = torch_log_mel(x.to(torch.bfloat16), None)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("t,chunk", [(10, 3), (12, 3), (7, 1)])
def test_masks_match_jax(t, chunk):
    x_len = np.array([t, t - 4, 1], np.int32)
    want = JM.padding_mask(t, jnp.asarray(x_len))
    got = TM.padding_mask(t, torch.from_numpy(x_len))
    assert_close(got, want, EXACT)
    assert_close(TM.pad_mask_to_multiple(got, chunk), JM.pad_mask_to_multiple(want, chunk), EXACT)
    x = rand(3, t, 5, seed=t)
    got_x, got_pad = TM.pad_to_multiple(torch.from_numpy(x), chunk)
    want_x, want_pad = JM.pad_to_multiple(jnp.asarray(x), chunk)
    assert got_pad == want_pad
    assert_close(got_x, want_x, EXACT)
    sq = (rand(1, 1, t, t, seed=1) > 0).astype(np.float32)
    assert_close(TM.pad_mask_to_multiple(torch.from_numpy(sq), chunk),
                 JM.pad_mask_to_multiple(jnp.asarray(sq), chunk), EXACT)
    assert TM.padding_mask(t, None) is None


@pytest.mark.parametrize("h,g", [(2, 1), (4, 3), (2, 3)])
def test_head_layouts_match_jax(h, g):
    x = rand(2, 6 * g, 12, seed=h + g)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    assert_close(TA.split_heads(xt, h), JA.split_heads(xj, h), EXACT)
    assert_close(TA.merge_heads(TA.split_heads(xt, h)), xj, EXACT)
    grouped = TA.group_time(xt, h, g)
    assert_close(grouped, JA.group_time(xj, h, g), EXACT)
    assert_close(TA.ungroup_time(grouped, 12), JA.ungroup_time(JA.group_time(xj, h, g), 12),
                 EXACT)
    assert TA.NEG_INF == JA.NEG_INF


@pytest.mark.parametrize("hdp_of", ["half", "lane"])
@pytest.mark.parametrize("n,d,stride,hidden", [(13, 24, 1, 0), (7, 24, 3, 0), (9, 40, 1, 5)])
def test_rel_tables_match_jax(hdp_of, n, d, stride, hidden):
    hdp = d // 2 if hdp_of == "half" else 128
    assert_close(TRF.rel_rowtab(n, d, hdp, hidden_len=hidden, stride=stride),
                 JRF.rel_rowtab(n, d, hdp, jnp.float32, hidden_len=hidden, stride=stride), EXACT)
    assert_close(TRF.rel_keytab_halves(n + 2, d, hdp, stride=stride),
                 JRF.rel_keytab_halves(n + 2, d, hdp, jnp.float32, stride=stride), EXACT)


def test_cached_tables_are_the_half_width_tables():
    row, key = TRF.rel_tables(11, 9, 24, 3, torch.device("cpu"))
    assert_close(row, JRF.rel_rowtab(11, 24, 12, jnp.float32, stride=3), EXACT)
    assert_close(key, JRF.rel_keytab_halves(9, 24, 12, jnp.float32, stride=3), EXACT)
    assert TRF.rel_tables(11, 9, 24, 3, torch.device("cpu"))[0] is row


@pytest.mark.parametrize("hdp_of", ["half", "lane"])
@pytest.mark.parametrize("d,h", [(24, 2), (40, 4)])
def test_rel_w_plain_matches_jax(hdp_of, d, h):
    hdp = d // 2 if hdp_of == "half" else 128
    w = rand(d, d, seed=d, scale=0.3)
    assert_close(TRF.rel_w_plain(torch.from_numpy(w), h, hdp),
                 JRF.rel_w_plain(jnp.asarray(w), h, hdp), EXACT)


@pytest.mark.parametrize("hdp_of", ["half", "lane"])
@pytest.mark.parametrize("d,h,g,hidden", [(24, 2, 3, 0), (24, 4, 3, 3), (20, 2, 5, 0),
                                          (120, 4, 3, 0)])
def test_grouped_folds_match_jax(hdp_of, d, h, g, hidden):
    hdp = d // 2 if hdp_of == "half" else 128
    dhg = g * d // h
    w = rand(d, d, seed=g + d, scale=0.3)
    wt, wj = torch.from_numpy(w), jnp.asarray(w)
    assert_close(TRF._grouped_fold_weights(h, dhg, wt, g, hidden),
                 JRF._grouped_fold_weights(h, dhg, wj, g, hidden), EXACT)
    assert_close(TRF.rel_w_grouped(h, dhg, wt, g, hdp, hidden),
                 JRF.rel_w_grouped(h, dhg, wj, g, hdp, hidden), EXACT)
