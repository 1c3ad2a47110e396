"""PyTorch port vs the JAX package: the language models, on the CPU in fp32.

The pieces of the LM-Transformer's causal Transformer-XL attention (the
relative encoding, the causal skewing, the windowed mask), the causal
attention layer forward and backward, the logits of a narrowed
LM-Transformer through both JAX routes (XLA, and the Pallas kernels in
interpret mode), the cross entropy, the eval loss, one accumulated train
step against JAX ``Trainer.train_step_fn()``, and the LM-RNN through the
same LanguageModel. The JAX variables come from the JAX package's own init
and reach the port through utils/weights.from_jax (the LM-RNN's go the other
way, through utils/torch_compat.convert_lm). Inputs come from numpy with
fixed seeds.
"""

import functools
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from efficientconformer_tpu.config import from_dict
from efficientconformer_tpu.models.attentions import MultiHeadSelfAttention as JaxMHSA
from efficientconformer_tpu.models.lm import LanguageModel as JaxLM
from efficientconformer_tpu.models.lm import ce_loss as jax_ce_loss
from efficientconformer_tpu.ops import attention as JA
from efficientconformer_tpu.ops import masks as JM
from efficientconformer_tpu.ops import pos_enc as JP
from efficientconformer_tpu.training.trainer import Trainer as JaxTrainer
from efficientconformer_tpu.training.trainer import TrainerState
from efficientconformer_tpu.utils import torch_compat as TC
from efficientconformer_torch.models import factory
from efficientconformer_torch.models.attentions import MultiHeadSelfAttention
from efficientconformer_torch.models.lm import LanguageModel, ce_loss
from efficientconformer_torch.ops import attention as A
from efficientconformer_torch.ops import bias_attention as BA
from efficientconformer_torch.ops import masks as M
from efficientconformer_torch.ops import pos_enc as P
from efficientconformer_torch.training.trainer import Trainer
from efficientconformer_torch.utils.weights import from_jax, load_adam_state, params_from_jax
from test_torch_port_rel_attention import jax_mhsa_params, port_mhsa
from test_torch_port_training import adam_moments, rel_err, with_adam_state

LM_TRANSFORMER = "configs/LM-Transformer.json"
LM_RNN = "configs/LM-RNN.json"
VOCAB = 64
TOL = 1e-5           # fp32 pieces, same arithmetic
LAYER_TOL = 2e-5     # one attention layer, fp32 sums in another order
LOGITS_TOL = 1e-4    # fp32 logits after the whole model
LOSS_RTOL = 1e-5     # fp32 loss, same arithmetic in another order
GRAD_TOL = 1e-4      # gradients, relative to max(max|g|, 1): sums over the batch
PARAM_TOL = 1e-5     # one Adam update from a shared non-zero state, lr ~ 1e-4


def lm_config(path=LM_TRANSFORMER, **training) -> dict:
    """The config at ``path`` narrowed (LM-Transformer: 2 blocks, d 64, 4
    heads; LM-RNN: 2 layers of 32), a 64-token vocabulary, fp32, dropout 0;
    its own training_params otherwise, with a short warm-up so that the
    learning rate of a few steps is not ~0."""
    with open(path) as f:
        cfg = json.load(f)
    if cfg["lm_params"]["arch"] == "Transformer":
        cfg["lm_params"].update(num_blocks=2, dim_model=64, num_heads=4, Pdrop=0.0)
    else:
        cfg["lm_params"].update(num_layers=2, dim_model=32)
    cfg["lm_params"]["vocab_size"] = cfg["tokenizer_params"]["vocab_size"] = VOCAB
    cfg["training_params"].update({"mixed_precision": False, "warmup_steps": 20, **training})
    return cfg


def lm_batch(lengths, u, seed):
    """tokens (B, U) in [1, V) and 0 past each length, token_len, and targets
    (B, U+1): the tokens, then 0, then -1 padding (data/loader.py:223-229)."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths, np.int32)
    tokens = rng.integers(1, VOCAB, (len(lengths), u)).astype(np.int32)
    tokens[np.arange(u)[None] >= lengths[:, None]] = 0
    targets = np.full((len(lengths), u + 1), -1, np.int32)
    targets[:, :u] = np.where(tokens > 0, tokens, -1)
    targets[np.arange(len(lengths)), lengths] = 0
    return {"tokens": tokens, "token_len": lengths, "targets": targets}


def jax_lm_and_variables(cfg, batch, seed=0):
    jm = JaxLM(lm_params=cfg["lm_params"], vocab_size=VOCAB)
    variables = jm.init(jax.random.PRNGKey(seed), jnp.asarray(batch["tokens"]),
                        jnp.asarray(batch["token_len"]))
    return jm, jax.tree.map(np.asarray, variables)


def port_lm(cfg, variables) -> LanguageModel:
    model = LanguageModel(cfg["lm_params"], VOCAB)
    model.load_state_dict(from_jax(variables), strict=True)
    return model.eval()


# ------------------------------------------------------------ the pieces


@pytest.mark.parametrize("t,causal", [(7, True), (7, False), (1, True), (101, True)])
def test_relative_encoding_matches_jax(t, causal):
    want = JP.relative_encoding(t, 24, causal=causal)
    got = P.relative_encoding(t, 24, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("t,hidden", [(6, 0), (1, 0), (5, 4)])
def test_rel_to_abs_causal_matches_jax(t, hidden):
    x = np.random.default_rng(t).standard_normal((2, 3, t, hidden + t)).astype(np.float32)
    want = JA.rel_to_abs_causal(jnp.asarray(x))
    got = A.rel_to_abs_causal(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("left,right,lengths", [(2048, 0, [7, 4, 1]), (2, 1, [7, 5, 3]),
                                                (3, 0, None)])
def test_masks_match_jax(left, right, lengths):
    x_len = None if lengths is None else np.asarray(lengths, np.int32)
    want = JM.streaming_mask(7, None if x_len is None else jnp.asarray(x_len), left, right)
    got = M.streaming_mask(7, None if x_len is None else torch.from_numpy(x_len), left, right)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if right == 0 and x_len is not None:
        want = JM.look_ahead_mask(7, jnp.asarray(x_len))
        got = M.look_ahead_mask(7, torch.from_numpy(x_len))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("masked", [True, False])
def test_causal_attention_layer_matches_jax(masked):
    """Output and the gradients of sum(sin(out)) in the input and every
    parameter, through the skewing path and the bias attention."""
    d, h, t = 24, 2, 11
    x = np.random.default_rng(20).standard_normal((3, t, d)).astype(np.float32) * 0.5
    mask = JM.look_ahead_mask(t, jnp.asarray([11, 6, 1])) if masked else None
    mod = MultiHeadSelfAttention(d, h, causal=True, relative_pos_enc=True).eval()
    mod.load_state_dict(port_mhsa(d, h, 1, seed=21).state_dict())
    jmod = JaxMHSA(dim_model=d, num_heads=h, causal=True, relative_pos_enc=True, fused=False)

    def jloss(params, xx):
        out, _ = jmod.apply({"params": params}, xx, mask)
        return jnp.sum(jnp.sin(out)), out

    (_, want), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jax_mhsa_params(mod), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out = mod(tx, None if mask is None else torch.from_numpy(np.array(mask)))
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0, atol=LAYER_TOL)
    assert rel_err(tx.grad, torch.from_numpy(np.array(gx))) <= GRAD_TOL
    for name in ("query", "key", "value", "output", "pos"):
        layer = getattr(mod, f"{name}_layer")
        for got, want_g in ((layer.weight.grad, np.asarray(gp[name]["kernel"]).T),
                            (layer.bias.grad, np.asarray(gp[name]["bias"]))):
            assert rel_err(got, torch.from_numpy(np.array(want_g))) <= GRAD_TOL, name
    for name in ("u", "v"):
        assert rel_err(getattr(mod, name).grad, torch.from_numpy(np.array(gp[name]))) <= GRAD_TOL


def test_bf16_bias_is_fp32(monkeypatch):
    """Under bf16 the rel scores are bf16 and the mask fp32, so the bias the
    kernel gets is fp32, as in the JAX package; q, k and v stay bf16."""
    mod = MultiHeadSelfAttention(16, 2, causal=True, relative_pos_enc=True).eval()
    seen, attend = [], BA.bias_attention

    def spy(q, k, v, bias, scale):
        seen.append((q.dtype, k.dtype, v.dtype, bias.dtype))
        return attend(q, k, v, bias, scale)

    monkeypatch.setattr(BA, "bias_attention", spy)
    x = torch.randn(2, 5, 16, generator=torch.Generator().manual_seed(0)).bfloat16()
    with torch.no_grad():
        out = mod(x, M.look_ahead_mask(5, torch.tensor([5, 3])))
    assert out.dtype == torch.bfloat16
    assert seen == [(torch.bfloat16, torch.bfloat16, torch.bfloat16, torch.float32)]


# ------------------------------------------------------------ the models


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_lm_transformer_logits_match_jax(monkeypatch, route):
    """Logits of ragged sequences (a full one, a short one, an empty one),
    against JAX's XLA attention and, with ECF_FUSED_ATTENTION=1, against its
    Pallas kernels in interpret mode."""
    if route == "pallas":
        monkeypatch.setenv("ECF_FUSED_ATTENTION", "1")
        monkeypatch.setattr(pl, "pallas_call",
                            functools.partial(pl.pallas_call, interpret=True))
    cfg = lm_config()
    batch = lm_batch([9, 4, 0], 9, seed=1)
    jm, variables = jax_lm_and_variables(cfg, batch)
    want = jm.apply(variables, jnp.asarray(batch["tokens"]), jnp.asarray(batch["token_len"]))
    model = port_lm(cfg, variables)
    with torch.no_grad():
        got = model(torch.from_numpy(batch["tokens"]), torch.from_numpy(batch["token_len"]))
    assert got.shape == (3, 10, VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGITS_TOL)


def test_ce_loss_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 6, VOCAB)).astype(np.float32) * 3
    targets = lm_batch([5, 2, 0], 5, seed=3)["targets"]
    want = jax_ce_loss(jnp.asarray(logits), jnp.asarray(targets))
    got = ce_loss(torch.from_numpy(logits), torch.from_numpy(targets))
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)
    empty = np.full_like(targets, -1)
    assert float(ce_loss(torch.from_numpy(logits), torch.from_numpy(empty))) == 0.0


@pytest.mark.parametrize("path", [LM_TRANSFORMER, LM_RNN])
def test_eval_loss_matches_jax(path):
    """Trainer.eval_loss against JAX Trainer.eval_loss_fn() on one unstacked
    batch: the mean cross entropy whose exponential is the perplexity."""
    cfg = lm_config(path)
    batch = lm_batch([8, 3, 6, 1], 8, seed=4)
    jt = JaxTrainer(from_dict(cfg))
    state = jt.init_state(jax.tree.map(jnp.asarray, batch))
    want = jt.eval_loss_fn()(state, jax.tree.map(jnp.asarray, batch))
    trainer = Trainer(cfg, device="cpu")
    trainer.model.load_state_dict(from_jax({"params": jax.tree.map(np.asarray, state.params)}),
                                  strict=True)
    got = trainer.eval_loss(batch)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    assert not trainer.model.training


def lm_train_batch(seed=5):
    """Two stacked microbatches of 3 ragged sequences."""
    mbs = [lm_batch([7, 3, 5], 7, seed), lm_batch([2, 7, 6], 7, seed + 1)]
    return {k: np.stack([mb[k] for mb in mbs]) for k in mbs[0]}


def run_both(cfg, adam_count=None):
    """One step of each package from the same weights: (port trainer, its
    (loss, grad_norm), the JAX params before, JAX's new state and metrics)."""
    batch = lm_train_batch()
    jt = JaxTrainer(from_dict(cfg))
    state = jt.init_state(jax.tree.map(lambda x: jnp.asarray(x[0]), batch))
    params = jax.tree.map(np.asarray, state.params)
    port = Trainer(cfg, device="cpu", seed=0)
    port.model.load_state_dict(from_jax({"params": params}), strict=True)
    opt_state, step = state.opt_state, 0
    if adam_count is not None:
        mu, nu = adam_moments(params)
        opt_state = with_adam_state(opt_state, mu, nu, adam_count)
        load_adam_state(port.optimizer, port.model, mu, nu, adam_count)
        port.step = step = adam_count
    state = TrainerState(params=state.params, batch_stats=state.batch_stats,
                         opt_state=opt_state, step=jnp.asarray(step, jnp.int32))
    new, metrics = jt.train_step_fn()(state, jax.tree.map(jnp.asarray, batch),
                                      jax.random.PRNGKey(0))
    got = port.train_step(batch)
    return port, got, params, new, metrics


def test_lm_train_step_matches_jax():
    """Loss, global gradient norm and the updated parameters after one
    accumulated Adam step (A = 2 microbatches) of the config's optimizer
    (betas 0.9/0.95, eps 1e-8, no weight decay) under its Cosine schedule,
    from a shared non-zero Adam state: the pos layer's bias has a gradient
    that is 0 in exact arithmetic (it shifts every score of a row alike),
    which a fresh Adam would turn into +-lr."""
    port, (loss, grad_norm), _, new, metrics = run_both(lm_config(), adam_count=10)
    np.testing.assert_allclose(float(loss), float(metrics["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(grad_norm), float(metrics["grad_norm"]), rtol=LOSS_RTOL)
    want = params_from_jax(jax.tree.map(np.asarray, new.params))
    for name, p in port.model.named_parameters():
        torch.testing.assert_close(p.detach(), want[name], rtol=0, atol=PARAM_TOL, msg=name)


def test_lm_train_step_gradients_match_jax():
    """The averaged gradients of the accumulated step, read off a plain SGD
    step with learning rate 1 in JAX (new = old - g) and off .grad in the
    port."""
    cfg = lm_config(optimizer="SGD", momentum=0.0, weight_decay=0.0, lr_schedule="Constant",
                    lr_value=1.0)
    port, (loss, _), before, new, metrics = run_both(cfg)
    np.testing.assert_allclose(float(loss), float(metrics["loss"]), rtol=LOSS_RTOL)
    grads = params_from_jax(jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                                         before, new.params))
    for name, p in port.model.named_parameters():
        assert rel_err(p.grad, grads[name]) <= GRAD_TOL, name


def test_lm_fit_learns_with_dropout():
    """Training mode: dropout draws from the trainer's generator, and the
    loss of one repeated batch falls."""
    cfg = lm_config(lr_schedule="Constant", lr_value=3e-3)
    cfg["lm_params"]["Pdrop"] = 0.1
    trainer = Trainer(cfg, device="cpu", seed=1)
    losses = trainer.fit(iter([lm_train_batch(seed=7)] * 8), steps=8)
    assert len(losses) == 8 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    with pytest.raises(ValueError, match="no encoder"):
        trainer.train_step(lm_train_batch(), freeze_encoder=True)


def test_lm_rnn_logits_and_loss_match_jax():
    """LM-RNN through the same LanguageModel (the RNN decoder of the
    Transducer): logits and cross entropy, the port's weights carried to JAX
    by torch_compat.convert_lm and back by from_jax."""
    cfg = lm_config(LM_RNN)
    model, _ = factory.create_model(cfg, "cpu", torch.Generator().manual_seed(6))
    model.eval()
    params, _ = TC.convert_lm(model.state_dict())
    back = from_jax({"params": params})
    assert set(back) == set(model.state_dict())
    for k, v in model.state_dict().items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0, msg=k)
    batch = lm_batch([6, 2, 0], 6, seed=8)
    jm = JaxLM(lm_params=cfg["lm_params"], vocab_size=VOCAB)
    want = jm.apply({"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(batch["tokens"]),
                    jnp.asarray(batch["token_len"]))
    with torch.no_grad():
        got = model(torch.from_numpy(batch["tokens"]), torch.from_numpy(batch["token_len"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGITS_TOL)
    np.testing.assert_allclose(
        float(ce_loss(got, torch.from_numpy(batch["targets"]))),
        float(jax_ce_loss(want, jnp.asarray(batch["targets"]))), rtol=LOSS_RTOL)


def test_lm_weight_bridge_names():
    """from_jax of the JAX LanguageModel tree gives every port parameter,
    in the port's key scheme, and nothing else."""
    cfg = lm_config()
    _, variables = jax_lm_and_variables(cfg, lm_batch([3], 3, seed=9))
    sd = from_jax(variables)
    model = LanguageModel(cfg["lm_params"], VOCAB)
    assert set(sd) == set(model.state_dict())
    assert "decoder.blocks.1.multi_head_self_attention_module.mhsa.pos_layer.weight" in sd
    assert "decoder.blocks.0.feed_forward_module.layers.3.weight" in sd
    block = variables["params"]["decoder"]["block_0"]
    np.testing.assert_array_equal(
        sd["decoder.blocks.0.feed_forward_module.layers.3.weight"].numpy(),
        np.asarray(block["ffn"]["fc2"]["kernel"]).T)
