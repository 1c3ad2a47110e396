"""PyTorch port vs the JAX package: Conformer block, encoder and ModelCTC
with greedy decoding, on the CPU in fp32.

The port's weights come from a seeded generator; the JAX variables are made
from the port's state_dict by utils/torch_compat.convert_ctc, so no flax init
runs. Norm parameters and BatchNorm running statistics are drawn away from
their defaults so that the eval-mode normalisation is exercised.
"""

import glob
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from efficientconformer_tpu import config as jax_config
from efficientconformer_tpu.models.blocks import ConformerBlock as JaxBlock
from efficientconformer_tpu.models.model_ctc import ModelCTC as JaxModelCTC
from efficientconformer_tpu.models.model_ctc import greedy_decode as jax_greedy_decode
from efficientconformer_tpu.utils import torch_compat as TC
from efficientconformer_torch import config as port_config
from efficientconformer_torch.models.blocks import ConformerBlock
from efficientconformer_torch.models.model_ctc import (
    ModelCTC,
    build_model,
    ctc_greedy_collapse,
    greedy_decode,
    init_params_,
)

LOGITS_TOL = 1e-4   # the bound of tests/test_torch_parity.py
FLAGSHIP = "configs/EfficientConformerCTCSmall.json"


def narrow_flagship() -> dict:
    """The flagship's encoder cut to 5 blocks and narrow widths: 3 stages,
    G = 3 in stage 1, strided and expand blocks [1, 3]."""
    with open(FLAGSHIP) as f:
        p = json.load(f)["encoder_params"]
    p.update(num_blocks=5, dim_model=[24, 36, 48], num_heads=4, subsampling_filters=[8],
             strided_blocks=[1, 3], expand_blocks=[1, 3], kernel_size=7)
    return p


def perturb_norms_(model: torch.nn.Module, seed: int) -> None:
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.LayerNorm, torch.nn.modules.batchnorm._BatchNorm)):
                n = m.weight.shape
                m.weight.copy_(1.0 + 0.1 * torch.randn(n, generator=gen))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))
                if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                    m.running_mean.copy_(0.2 * torch.randn(n, generator=gen))
                    m.running_var.copy_(0.5 + torch.rand(n, generator=gen))


def port_model(enc_params, vocab=32, seed=0) -> ModelCTC:
    model = ModelCTC(enc_params, vocab)
    init_params_(model, torch.Generator().manual_seed(seed))
    perturb_norms_(model, seed + 1)
    return model.eval()


def jax_variables(state_dict):
    params, stats = TC.convert_ctc(state_dict)
    return {"params": jax.tree.map(jnp.asarray, params),
            "batch_stats": jax.tree.map(jnp.asarray, stats)}


def ragged_audio(b, t, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, t)) * 0.1).astype(np.float32)
    x_len = np.linspace(t // 2, t, b).astype(np.int32) if b > 1 else np.array([t], np.int32)
    x_len[-1] = t
    for i in range(b):
        x[i, x_len[i]:] = 0.0
    return x, x_len


def jax_apply(module, variables, *args):
    """``module.apply`` under jit: compiling once is faster on the CPU than
    the first eager run, which compiles op by op."""
    return jax.jit(lambda v, *a: module.apply(v, *a))(variables, *map(jnp.asarray, args))


def valid_frames(logits, lengths):
    return [logits[i, :n] for i, n in enumerate(lengths)]


def encoder_configs():
    found = []
    for path in sorted(glob.glob("configs/*.json")):
        with open(path) as f:
            if "encoder_params" in json.load(f):
                found.append(path)
    return found


@pytest.mark.parametrize("path", encoder_configs(), ids=os.path.basename)
def test_block_configs_match_jax_package(path):
    with open(path) as f:
        p = json.load(f)["encoder_params"]
    assert port_config.resolve_block_configs(p) == [
        port_config.BlockConfig(**vars(b)) for b in jax_config.resolve_block_configs(p)]
    for samples in (16000, 16000 * 7 + 123):
        assert (port_config.encoder_output_frames(p, samples)
                == jax_config.encoder_output_frames(p, samples))


@pytest.mark.parametrize("d_in,d_out,stride,g", [(16, 24, 2, 3), (16, 16, 2, 1), (24, 24, 1, 3)])
def test_conformer_block_matches_jax(d_in, d_out, stride, g):
    p = narrow_flagship()
    p.update(num_blocks=1, dim_model=[d_in, d_out] if d_in != d_out else d_in, num_heads=2,
             att_group_size=g, strided_blocks=[0] if stride > 1 else [],
             expand_blocks=[0] if d_in != d_out else [])
    cfg = port_config.resolve_block_configs(p)[0]
    assert (cfg.dim_model, cfg.dim_expand, cfg.stride) == (d_in, d_out, stride)
    block = ConformerBlock(cfg).eval()
    init_params_(block, torch.Generator().manual_seed(7))
    perturb_norms_(block, 8)
    sd = {f"encoder.blocks.0.{k}": v for k, v in block.state_dict().items()}
    params, stats = TC.convert_encoder(TC._to_numpy(sd))
    variables = {"params": params["block_0"], "batch_stats": stats["block_0"]}

    t = 23
    x = np.random.default_rng(1).standard_normal((2, t, d_in)).astype(np.float32)
    mask = np.zeros((2, 1, 1, t), np.float32)
    mask[1, ..., t - 6:] = 1.0
    want, _ = jax_apply(JaxBlock(port_config.BlockConfig(**vars(cfg))),
                        jax.tree.map(jnp.asarray, variables), x, mask)
    with torch.no_grad():
        got = block(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.shape == want.shape == (2, (t - 1) // stride + 1, d_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGITS_TOL)


@pytest.mark.parametrize("b,t", [(2, 16000), (3, 7777)])
def test_narrowed_ctc_model_matches_jax(b, t):
    enc_params = narrow_flagship()
    model = port_model(enc_params)
    variables = jax_variables(model.state_dict())
    jax_model = JaxModelCTC(encoder_params=enc_params, vocab_size=32)
    x, x_len = ragged_audio(b, t, seed=t)

    want, want_len, _ = jax_apply(jax_model, variables, x, x_len)
    with torch.no_grad():
        got, got_len = model(torch.from_numpy(x), torch.from_numpy(x_len))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    for g_, w_ in zip(valid_frames(got.numpy(), got_len), valid_frames(np.asarray(want), got_len)):
        np.testing.assert_allclose(g_, w_, rtol=0, atol=LOGITS_TOL)

    want_tok, want_n = jax_greedy_decode(jax_model, variables, jnp.asarray(x), jnp.asarray(x_len))
    got_tok, got_n = greedy_decode(model, torch.from_numpy(x), torch.from_numpy(x_len))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))


def test_flagship_full_width_matches_jax():
    """EfficientConformerCTCSmall at its published widths, on 1 s of audio."""
    gen = torch.Generator().manual_seed(11)
    model = build_model(FLAGSHIP, "cpu", torch.float32, gen)
    perturb_norms_(model, 12)
    with open(FLAGSHIP) as f:
        cfg = json.load(f)
    jax_model = JaxModelCTC(encoder_params=cfg["encoder_params"],
                            vocab_size=cfg["tokenizer_params"]["vocab_size"])
    x, x_len = ragged_audio(2, 16000, seed=5)
    want, want_len, _ = jax_apply(jax_model, jax_variables(model.state_dict()), x, x_len)
    with torch.no_grad():
        got, got_len = model(torch.from_numpy(x), torch.from_numpy(x_len))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    for g_, w_ in zip(valid_frames(got.numpy(), got_len), valid_frames(np.asarray(want), got_len)):
        np.testing.assert_allclose(g_, w_, rtol=0, atol=LOGITS_TOL)
        np.testing.assert_array_equal(g_.argmax(-1), w_.argmax(-1))


def test_ctc_greedy_collapse():
    preds = torch.tensor([[0, 3, 3, 0, 3, 5, 5, 2], [4, 4, 0, 0, 1, 1, 1, 7]])
    tokens, counts = ctc_greedy_collapse(preds, torch.tensor([8, 6]))
    assert counts.tolist() == [4, 2]
    assert tokens.tolist() == [[3, 3, 5, 2, 0, 0, 0, 0], [4, 1, 0, 0, 0, 0, 0, 0]]


def test_encoder_refuses_training_mode():
    """Training mode draws SpecAugment and dropout masks from an explicit
    generator; without one the encoder refuses to train."""
    model = port_model(narrow_flagship()).train()
    with pytest.raises(ValueError, match="Generator"):
        model(torch.zeros(1, 4000), torch.tensor([4000]))
    logits, _ = model(torch.zeros(1, 4000), torch.tensor([4000]), torch.Generator())
    assert torch.isfinite(logits).all()


def test_bf16_compute_tracks_fp32():
    """compute_dtype bf16: frontend in fp32, the rest in bf16 with fp32
    master weights; logits stay near the fp32 ones."""
    enc_params = narrow_flagship()
    model32 = port_model(enc_params)
    model16 = port_model(dict(enc_params, compute_dtype="bfloat16"))
    x, x_len = ragged_audio(2, 8000, seed=2)
    with torch.no_grad():
        want, _ = model32(torch.from_numpy(x), torch.from_numpy(x_len))
        got, got_len = model16(torch.from_numpy(x), torch.from_numpy(x_len))
    assert got.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model16.parameters())
    # bf16 keeps 8 mantissa bits: ~0.4% per rounding, over 5 blocks
    assert (got.float() - want).abs().max().item() < 0.15
