"""PyTorch port vs the JAX package: the training slice, on the CPU in fp32.

The CTC train step (training/trainer.py) of the narrowed flagship against
JAX ``Trainer.train_step_fn()`` from the same weights (via
utils/torch_compat.convert_ctc) and the same Adam state (via
utils/weights.load_adam_state), with dropout 0 and SpecAugment off, since
random masks cannot match across frameworks. Then each piece alone:
SpecAugment fed the JAX package's own uniforms, train-mode BatchNorm vs
flax, the CTC loss, the five schedules and the optimizers. Inputs come from
numpy with fixed seeds.
"""

import copy
import json

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from efficientconformer_tpu.config import from_dict
from efficientconformer_tpu.models.layers import batch_norm as jax_batch_norm
from efficientconformer_tpu.ops.ctc_loss import ctc_loss as jax_ctc_loss
from efficientconformer_tpu.ops.specaugment import spec_augment as jax_spec_augment
from efficientconformer_tpu.training import optimizers as jax_optimizers
from efficientconformer_tpu.training import schedules as jax_schedules
from efficientconformer_tpu.training.trainer import Trainer as JaxTrainer
from efficientconformer_tpu.training.trainer import TrainerState
from efficientconformer_tpu.utils import torch_compat as TC
from efficientconformer_torch.models.layers import BatchNorm1d, BatchNorm2d, Dropout
from efficientconformer_torch.ops import specaugment
from efficientconformer_torch.ops.ctc_loss import ctc_loss
from efficientconformer_torch.training import optimizers, schedules
from efficientconformer_torch.training.trainer import Trainer
from efficientconformer_torch.utils.weights import load_adam_state, params_from_jax
from test_torch_port_model import FLAGSHIP, narrow_flagship

VOCAB = 16
LOSS_RTOL = 1e-5     # fp32 loss, same arithmetic in another order
GRAD_TOL = 1e-4      # gradients, relative to max(max|g|, 1): sums over the batch
PARAM_TOL = 1e-5     # one Adam update from a shared non-zero state, lr ~ 1e-3
STATS_TOL = 1e-4     # BatchNorm running statistics, relative to max(|x|, 1)


def train_config(**training) -> dict:
    """The flagship's config with the narrowed encoder, fp32, dropout 0 and
    SpecAugment off; its own training_params otherwise (Adam, Transformer
    schedule, weight decay 1e-6, accumulated_steps 2)."""
    with open(FLAGSHIP) as f:
        cfg = json.load(f)
    cfg["encoder_params"] = dict(narrow_flagship(), Pdrop=0.0, spec_augment=False)
    cfg["tokenizer_params"]["vocab_size"] = VOCAB
    cfg["training_params"].update({"mixed_precision": False, "warmup_steps": 20, **training})
    return cfg


def train_batch(seed=0):
    """Two stacked microbatches of 3 ragged utterances, with a label-free
    one (y_len = 0) and padded frames."""
    rng = np.random.default_rng(seed)
    a, b, t, u = 2, 3, 12000, 4
    audio = (rng.standard_normal((a, b, t)) * 0.1).astype(np.float32)
    audio_len = np.array([[12000, 9000, 7000], [11000, 12000, 6000]], np.int32)
    for i in range(a):
        for j in range(b):
            audio[i, j, audio_len[i, j]:] = 0.0
    return {"audio": audio, "audio_len": audio_len,
            "labels": rng.integers(1, VOCAB, (a, b, u)).astype(np.int32),
            "label_len": np.array([[4, 2, 0], [3, 4, 1]], np.int32)}


def adam_moments(params, seed=5):
    """Non-zero Adam moments shaped like the params: the first update of a
    fresh Adam divides each gradient by its own magnitude, which turns the
    rounding noise of gradients that are 0 in exact arithmetic (biases ahead
    of a BatchNorm, the key bias under the softmax) into +-lr; from a state
    with real second moments the update is well conditioned."""
    rng = np.random.default_rng(seed)
    mu = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 1e-3).astype(np.float32), params)
    nu = jax.tree.map(lambda x: rng.uniform(1e-4, 1e-3, x.shape).astype(np.float32), params)
    return mu, nu


def with_adam_state(opt_state, mu, nu, count):
    def replace(s):
        if isinstance(s, optax.ScaleByAdamState):
            return s._replace(mu=jax.tree.map(jnp.asarray, mu), nu=jax.tree.map(jnp.asarray, nu),
                              count=jnp.asarray(count, jnp.int32))
        if "count" in getattr(s, "_fields", ()):
            return s._replace(count=jnp.asarray(count, jnp.int32))
        return s
    return tuple(replace(s) for s in opt_state)


def run_both(cfg, freeze_encoder=False, adam_count=None, batch=None):
    """One step of each package from the same weights: (port trainer, its
    (loss, grad_norm), the weights before, JAX's new state and metrics)."""
    port = Trainer(cfg, device="cpu", seed=0)
    params, stats = (jax.tree.map(np.array, t) for t in TC.convert_ctc(port.model.state_dict()))
    jt = JaxTrainer(from_dict(cfg))
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state, step = jt.tx.init(jparams), 0
    if adam_count is not None:
        mu, nu = adam_moments(params)
        opt_state = with_adam_state(opt_state, mu, nu, adam_count)
        load_adam_state(port.optimizer, port.model, mu, nu, adam_count)
        port.step = step = adam_count
    state = TrainerState(params=jparams, batch_stats=jax.tree.map(jnp.asarray, stats),
                         opt_state=opt_state, step=jnp.asarray(step, jnp.int32))
    batch = train_batch() if batch is None else batch
    new, metrics = jt.train_step_fn(freeze_encoder=freeze_encoder)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    got = port.train_step(batch, freeze_encoder=freeze_encoder)
    return port, got, params, new, metrics


def rel_err(got, want):
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1.0)


@pytest.mark.parametrize("freeze_encoder", [False, True])
def test_train_step_matches_jax(freeze_encoder):
    """Loss, global gradient norm, updated parameters and BatchNorm running
    statistics after one accumulated Adam step (A = 2 microbatches), and,
    with freeze_encoder, an encoder that did not move while the head did."""
    port, (loss, grad_norm), before, new, metrics = run_both(
        train_config(), freeze_encoder, adam_count=10)
    np.testing.assert_allclose(float(loss), float(metrics["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(grad_norm), float(metrics["grad_norm"]), rtol=LOSS_RTOL)
    want_params = params_from_jax(jax.tree.map(np.asarray, new.params))
    start = params_from_jax(before)
    for name, p in port.model.named_parameters():
        torch.testing.assert_close(p.detach(), want_params[name], rtol=0, atol=PARAM_TOL,
                                   msg=name)
        moved = (p.detach() - start[name]).abs().max().item()
        if freeze_encoder and name.startswith("encoder."):
            assert moved == 0.0, name
        elif name.startswith("fc."):
            assert moved > 0.0, name
    _, got_stats = TC.convert_ctc(port.model.state_dict())
    flat_got = jax.tree_util.tree_leaves_with_path(got_stats)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, new.batch_stats)))
    assert len(flat_got) == len(flat_want)
    for path, got in flat_got:
        want_ = torch.from_numpy(np.array(flat_want[path]))
        assert rel_err(torch.from_numpy(np.array(got)), want_) <= STATS_TOL, path


def test_train_step_gradients_match_jax():
    """The averaged gradients of the accumulated step, read off a plain SGD
    step with learning rate 1 in JAX (new = old - g) and off .grad in the
    port."""
    cfg = train_config(optimizer="SGD", momentum=0.0, weight_decay=0.0,
                       lr_schedule="Constant", lr_value=1.0)
    port, (loss, _), before, new, metrics = run_both(cfg)
    np.testing.assert_allclose(float(loss), float(metrics["loss"]), rtol=LOSS_RTOL)
    grads = params_from_jax(jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                                         before, new.params))
    for name, p in port.model.named_parameters():
        assert rel_err(p.grad, grads[name]) <= GRAD_TOL, name


def test_train_step_with_an_infeasible_utterance_matches_jax():
    """An utterance of 5 frames with 8 labels in the second microbatch: the
    JAX step averages its ~1e30 loss in and stays finite; the port's step
    matches it (loss, gradient norm, updated parameters) from the same
    non-zero Adam state, and every parameter stays finite."""
    batch = train_batch()
    rng = np.random.default_rng(7)
    labels = rng.integers(1, VOCAB, (2, 3, 8)).astype(np.int32)
    label_len = np.array([[4, 2, 0], [3, 4, 8]], np.int32)     # 6000 samples: 5 frames
    labels[np.arange(8)[None, None, :] >= label_len[..., None]] = 0
    batch.update(labels=labels, label_len=label_len)
    port, (loss, grad_norm), _, new, metrics = run_both(train_config(), adam_count=10,
                                                         batch=batch)
    assert float(metrics["loss"]) > 1e28
    np.testing.assert_allclose(float(loss), float(metrics["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(grad_norm), float(metrics["grad_norm"]), rtol=LOSS_RTOL)
    want_params = params_from_jax(jax.tree.map(np.asarray, new.params))
    for name, p in port.model.named_parameters():
        assert bool(torch.isfinite(p).all()), name
        torch.testing.assert_close(p.detach(), want_params[name], rtol=0, atol=PARAM_TOL,
                                   msg=name)


def test_fit_trains_and_stops_with_the_batches():
    cfg = train_config(lr_schedule="Constant", lr_value=1e-3)
    cfg["encoder_params"].update(Pdrop=0.1, spec_augment=True)
    trainer = Trainer(cfg, device="cpu", seed=1)
    batch = train_batch(seed=3)
    losses = trainer.fit(iter([batch] * 6), steps=10)
    assert len(losses) == 6 and trainer.step == 6
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_apply_model_dispatches_train_and_eval():
    """Eval: no autograd, running statistics untouched, the same logits as
    the eval-mode module. Train: batch statistics, running statistics
    updated, SpecAugment and dropout from the generator."""
    from efficientconformer_torch.models import factory

    cfg = train_config()
    cfg["encoder_params"].update(Pdrop=0.1, spec_augment=True)
    model, _ = factory.create_model(cfg, "cpu", torch.Generator().manual_seed(0))
    mb = {k: torch.from_numpy(v[0]) for k, v in train_batch().items()}
    stats = {n: b.clone() for n, b in model.named_buffers()}
    logits, lengths = factory.apply_model(model, mb, False)
    assert not logits.requires_grad and not model.training
    for n, b in model.named_buffers():
        torch.testing.assert_close(b, stats[n], rtol=0, atol=0, msg=n)
    with torch.no_grad():
        torch.testing.assert_close(logits, model(mb["audio"], mb["audio_len"])[0])
    train_logits, _ = factory.apply_model(model, mb, True, torch.Generator().manual_seed(1))
    assert train_logits.requires_grad and model.training
    assert not torch.equal(model.encoder.blocks[0].convolution_module.layers[5].running_mean,
                           stats["encoder.blocks.0.convolution_module.layers.5.running_mean"])


# ------------------------------------------------------------ the pieces


def test_spec_augment_matches_jax_with_the_same_uniforms():
    """The uniforms that ops/specaugment.py draws from its key splits, fed to
    the port's apply step: equal masks."""
    b, t, m = 3, 57, 80
    mF, F_, mT, pS = 2, 27, 5, 0.05
    x = np.random.default_rng(0).standard_normal((b, t, m)).astype(np.float32)
    x_len = np.array([57, 40, 23], np.int32)
    key = jax.random.PRNGKey(7)
    want = jax_spec_augment(key, jnp.asarray(x), jnp.asarray(x_len), mF=mF, F=F_, mT=mT, pS=pS)
    kf, kt = jax.random.split(key)
    kf1, kf2 = jax.random.split(kf)
    kt1, kt2 = jax.random.split(kt)
    uniforms = tuple(torch.from_numpy(np.array(u)) for u in (
        jax.random.uniform(kf1, (mF,)), jax.random.uniform(kf2, (mF,)),
        jax.random.uniform(kt1, (b, mT)), jax.random.uniform(kt2, (b, mT))))
    got = specaugment.apply(torch.from_numpy(x), torch.from_numpy(x_len), uniforms, F=F_, pS=pS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got == 0).any()


def test_spec_augment_draws_from_the_generator():
    x = torch.randn(2, 50, 80)
    x_len = torch.tensor([50, 30])
    outs = [specaugment.spec_augment(x, x_len, torch.Generator().manual_seed(s), mF=2, F=27,
                                     mT=5, pS=0.05) for s in (0, 0, 1)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    assert not torch.equal(outs[0], outs[2])
    assert (outs[0][1, 30:] == x[1, 30:]).logical_or(outs[0][1, 30:] == 0).all()


@pytest.mark.parametrize("layout", ["1d", "2d"])
def test_train_mode_batch_norm_matches_flax(layout):
    """Batch statistics over every axis but the features, padded frames
    included; running statistics 0.9 * old + 0.1 * batch with the biased
    variance, two updates in a row."""
    rng = np.random.default_rng(1)
    c = 6
    shape = (3, 7, c) if layout == "1d" else (2, 5, 4, c)     # channels-last, as flax
    xs = [(rng.standard_normal(shape) * 2 + 1).astype(np.float32) for _ in range(2)]
    bn = BatchNorm1d(c) if layout == "1d" else BatchNorm2d(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.standard_normal(c).astype(np.float32)))
        bn.running_mean.copy_(torch.from_numpy(rng.standard_normal(c).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, c).astype(np.float32)))
    variables = {"params": {"scale": jnp.asarray(bn.weight.detach().numpy()),
                            "bias": jnp.asarray(bn.bias.detach().numpy())},
                 "batch_stats": {"mean": jnp.asarray(bn.running_mean.numpy()),
                                 "var": jnp.asarray(bn.running_var.numpy())}}
    flax_bn = jax_batch_norm(True)
    bn.train()
    for x in xs:
        want, mutated = flax_bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": mutated["batch_stats"]}
        got = bn(torch.from_numpy(np.moveaxis(x, -1, 1)))
        np.testing.assert_allclose(np.moveaxis(got.detach().numpy(), 1, -1), np.asarray(want),
                                   rtol=0, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(variables["batch_stats"]["mean"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(variables["batch_stats"]["var"]), rtol=1e-5, atol=1e-6)


def test_dropout_draws_from_the_generator():
    x = torch.ones(4, 1000)
    drop = Dropout(0.25)
    torch.testing.assert_close(drop.eval()(x), x, rtol=0, atol=0)
    drop.train()
    a = drop(x, torch.Generator().manual_seed(3))
    b = drop(x, torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    kept = a != 0
    assert 0.7 < kept.float().mean().item() < 0.8
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.75))
    torch.testing.assert_close(Dropout(0.0).train()(x), x, rtol=0, atol=0)
    with pytest.raises(ValueError, match="Generator"):
        drop(x)


def ctc_case(seed=0):
    rng = np.random.default_rng(seed)
    b, t, v, u = 4, 20, 9, 5
    logits = rng.standard_normal((b, t, v)).astype(np.float32)
    labels = rng.integers(1, v, (b, u)).astype(np.int32)
    labels[0, 1] = labels[0, 0]                          # a repeat: needs a blank between
    f_len = np.array([20, 17, 11, 20], np.int32)         # f_len < T
    y_len = np.array([5, 3, 0, 2], np.int32)             # y_len = 0: the all-blank path
    return logits, labels, f_len, y_len


def test_ctc_loss_and_gradient_match_jax():
    logits, labels, f_len, y_len = ctc_case()

    def jax_loss(lg):
        return jnp.sum(jax_ctc_loss(jax.nn.log_softmax(lg, -1), jnp.asarray(labels),
                                    jnp.asarray(f_len), jnp.asarray(y_len)))

    want_nll = jax_ctc_loss(jax.nn.log_softmax(jnp.asarray(logits), -1), jnp.asarray(labels),
                            jnp.asarray(f_len), jnp.asarray(y_len))
    want_grad = jax.grad(jax_loss)(jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_(True)
    nll = ctc_loss(torch.log_softmax(lg, -1), torch.from_numpy(labels), torch.from_numpy(f_len),
                   torch.from_numpy(y_len))
    nll.sum().backward()
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(want_nll), rtol=1e-5)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(want_grad), rtol=0, atol=1e-5)
    assert (lg.grad.numpy()[1, 17:] == 0).all()          # frames past f_len


def test_ctc_loss_of_an_infeasible_lattice_matches_jax():
    """B 2, T 5, V 6: sample 0 has 7 labels in 5 frames (no path), sample 1
    3 labels with a repeat in 5 frames. The infeasible row gets the JAX
    recursion's loss (about 1e30) and its finite gradient; the feasible one
    stays on F.ctc_loss, which matches JAX as before."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 6)).astype(np.float32)
    labels = np.array([[1, 2, 3, 4, 5, 1, 2], [3, 3, 1, 0, 0, 0, 0]], np.int32)
    f_len, y_len = np.array([5, 5], np.int32), np.array([7, 3], np.int32)

    def jax_loss(lg):
        return jnp.sum(jax_ctc_loss(jax.nn.log_softmax(lg, -1), jnp.asarray(labels),
                                    jnp.asarray(f_len), jnp.asarray(y_len)))

    want_nll = jax_ctc_loss(jax.nn.log_softmax(jnp.asarray(logits), -1), jnp.asarray(labels),
                            jnp.asarray(f_len), jnp.asarray(y_len))
    want_grad = np.asarray(jax.grad(jax_loss)(jnp.asarray(logits)))
    lg = torch.from_numpy(logits).requires_grad_(True)
    nll = ctc_loss(torch.log_softmax(lg, -1), torch.from_numpy(labels), torch.from_numpy(f_len),
                   torch.from_numpy(y_len))
    nll.sum().backward()
    assert float(want_nll[0]) > 1e29
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(want_nll), rtol=1e-5)
    assert np.isfinite(lg.grad.numpy()).all()
    np.testing.assert_allclose(lg.grad.numpy(), want_grad, rtol=0, atol=1e-5)
    feasible = ctc_loss(torch.log_softmax(lg.detach(), -1)[1:], torch.from_numpy(labels)[1:],
                        torch.from_numpy(f_len)[1:], torch.from_numpy(y_len)[1:])
    assert torch.equal(feasible, nll.detach()[1:])      # the feasible row: F.ctc_loss, bitwise


@pytest.mark.parametrize("bad", [0, 9])
def test_ctc_loss_refuses_labels_out_of_range(bad):
    logits, labels, f_len, y_len = ctc_case()
    labels[1, 2] = bad
    with pytest.raises(ValueError, match="labels outside"):
        ctc_loss(torch.log_softmax(torch.from_numpy(logits), -1), torch.from_numpy(labels),
                 torch.from_numpy(f_len), torch.from_numpy(y_len))
    labels[1, 4] = bad                                   # past y_len: ignored
    labels[1, 2] = 1
    ctc_loss(torch.log_softmax(torch.from_numpy(logits), -1), torch.from_numpy(labels),
             torch.from_numpy(f_len), torch.from_numpy(y_len))


SCHEDULES = {
    "Constant": {"lr_value": 3e-4},
    "ConstantWithDecay": {"lr_values": [1e-3, 5e-4, 1e-4], "decay_steps": [10, 100]},
    "Transformer": {"schedule_dim": 240, "warmup_steps": 100, "K": 2},
    "ExpDecayTransformer": {"schedule_dim": 240, "warmup_steps": 100, "K": 2, "alpha": 0.1,
                            "end_step": 1000},
    "Cosine": {"schedule_dim": 240, "warmup_steps": 100, "K": 2, "lr_min": 1e-5,
               "end_step": 1000},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_jax(name):
    p = {"lr_schedule": name, **SCHEDULES[name]}
    got, want = schedules.from_training_params(p), jax_schedules.from_training_params(p)
    for count in (0, 1, 9, 10, 11, 99, 100, 101, 500, 999):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, err_msg=str(count))


@pytest.mark.parametrize("opt", ["Adam", "SGD"])
def test_optimizer_matches_optax_from_the_same_state(opt):
    """Three updates fed the same gradients, with L2 weight decay, under the
    Transformer schedule; Adam starts from a non-zero state carried over by
    load_adam_state, SGD has momentum."""
    tp = {"optimizer": opt, "beta1": 0.9, "beta2": 0.98, "eps": 1e-9, "momentum": 0.9,
          "weight_decay": 1e-2, **{"lr_schedule": "Transformer"}, **SCHEDULES["Transformer"]}
    trainer = Trainer(train_config(**tp), device="cpu", seed=2)
    model = trainer.model
    params = jax.tree.map(np.array, TC.convert_ctc(model.state_dict())[0])
    tx = jax_optimizers.from_training_params(tp)
    state, count = tx.init(jax.tree.map(jnp.asarray, params)), 0
    if opt == "Adam":
        count = 4
        mu, nu = adam_moments(params, seed=6)
        state = with_adam_state(state, mu, nu, count)
        load_adam_state(trainer.optimizer, model, mu, nu, count)
    jparams = jax.tree.map(jnp.asarray, params)
    rng = np.random.default_rng(3)
    for i in range(3):
        grads = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), params)
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        torch_grads = params_from_jax(grads)
        for name, p in model.named_parameters():
            p.grad = torch_grads[name].clone()
        optimizers.set_lr(trainer.optimizer, trainer.schedule(count + i))
        trainer.optimizer.step()
    want = params_from_jax(jax.tree.map(np.asarray, jparams))
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), want[name], rtol=1e-5, atol=1e-6, msg=name)


def test_training_options():
    """remat trains a step as the step without it (here the loss and the
    weights after the update; tests/test_torch_port_remat.py holds the rest).
    An InterCTC config without interctc_blocks builds the model with no
    taps, as in the JAX package (tests/test_torch_port_interctc.py holds the
    taps and the step without them); an unknown model type raises.
    Variational noise is ported, for the Transducer: a CTC model takes none,
    as in the JAX package, whose ModelCTC has no vn_std."""
    cfg = copy.deepcopy(train_config())
    cfg["encoder_params"]["remat"] = True
    batch = train_batch(seed=1)
    batch["audio"] = batch["audio"][..., :4000]    # 0.25 s: the step's shape is not the point
    batch["audio_len"] = np.minimum(batch["audio_len"], 4000)
    batch["label_len"] = np.minimum(batch["label_len"], 2)
    steps = []
    for c in (cfg, train_config()):
        trainer = Trainer(c, device="cpu", seed=0)
        loss, _ = trainer.train_step(batch)
        steps.append((loss.item(), trainer.model.state_dict()))
    assert steps[0][0] == pytest.approx(steps[1][0], rel=1e-6)
    for name, value in steps[1][1].items():
        torch.testing.assert_close(steps[0][1][name], value, rtol=1e-5, atol=1e-7, msg=name)
    inter = Trainer(dict(train_config(), model_type="InterCTC"), device="cpu").model
    assert inter.encoder.interctc_blocks == () and not any(
        "linear_expand" in n for n, _ in inter.named_parameters())
    with pytest.raises(ValueError, match="unknown model type"):
        Trainer(dict(train_config(), model_type="Other"), device="cpu")
    trainer = Trainer(train_config(vn_std=0.075, vn_start_step=0), device="cpu")
    assert all(getattr(m, "vn_std", None) is None for m in trainer.model.modules())
