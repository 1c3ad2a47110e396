"""PyTorch port vs the JAX package: the InterCTC model, on the CPU in fp32.

The taps' probabilities, the mixed loss (1 - lambda) * main + lambda *
mean_i ctc(log p_i) and its gradients against JAX ``factory.create_model``
on the same weights (a seeded port init through utils/torch_compat to JAX,
back through utils/weights.from_jax, loaded strictly) and inputs: tests/test_interctc.py's config (tap after block 0,
lambda 0.3), and the narrowed flagship with a tap before a strided block
(block 0: four times the final frames, every tap scored with the final
lengths as the JAX package scores them), one on a strided block (1) and
one on the last block (4). Then one step of the port's Trainer on the
InterCTC config. Inputs come from numpy with fixed seeds.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from efficientconformer_tpu.config import from_dict
from efficientconformer_tpu.models import factory as jax_factory
from efficientconformer_tpu.utils import torch_compat as TC
from efficientconformer_torch.models import factory
from efficientconformer_torch.training.trainer import Trainer
from efficientconformer_torch.utils.weights import from_jax, params_from_jax
from test_models import TINY_ENC
from test_torch_port_model import FLAGSHIP, narrow_flagship, perturb_norms_

VOCAB = 9
TOL = 1e-4           # fp32 loss and gradients (relative to max(max|g|, 1))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def interctc_config(enc, taps, lam) -> dict:
    with open(FLAGSHIP) as f:
        cfg = json.load(f)
    cfg.update(model_type="InterCTC", model_name="tiny interctc")
    cfg["encoder_params"] = dict(enc, interctc_blocks=taps, Pdrop=0.0, spec_augment=False)
    cfg["tokenizer_params"]["vocab_size"] = VOCAB
    cfg["training_params"].update(interctc_lambda=lam, mixed_precision=False)
    return cfg


CASES = {"test_interctc": (TINY_ENC, [0], 0.3), "strided": (narrow_flagship(), [0, 1, 4], 0.5)}


def batch(seed=0):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((2, 8000)) * 0.1).astype(np.float32)
    audio[1, 6000:] = 0.0
    return {"audio": audio, "audio_len": np.array([8000, 6000], np.int32),
            "labels": np.array([[1, 2, 3], [4, 5, 0]], np.int32),
            "label_len": np.array([3, 2], np.int32)}


def jax_and_port(cfg):
    """The JAX model and loss, its variables (a seeded port init through
    utils/torch_compat, which maps the taps as the original names them:
    flax's own init of the rel-pos layers runs eagerly for half a minute),
    and the port model loaded strictly from them through from_jax."""
    model, loss_fn = jax_factory.create_model(from_dict(cfg))
    seeded, _ = factory.create_model(cfg, "cpu", torch.Generator().manual_seed(0))
    perturb_norms_(seeded, 1)
    params, stats = TC.convert_ctc(seeded.state_dict())
    variables = {"params": params, "batch_stats": stats}
    port, port_loss = factory.create_model(cfg, "cpu", torch.Generator().manual_seed(1))
    port.load_state_dict(from_jax(variables), strict=True)
    b = {k: jnp.asarray(v) for k, v in batch().items()}
    return model, loss_fn, variables, b, port.eval(), port_loss


@pytest.mark.parametrize("case", CASES)
def test_interctc_loss_and_gradients_match_jax(case):
    cfg = interctc_config(*CASES[case])
    model, loss_fn, variables, b, port, port_loss = jax_and_port(cfg)

    def loss(params):
        outputs, _ = jax_factory.apply_model(
            model, {"params": params, "batch_stats": variables["batch_stats"]}, b, False)
        return loss_fn(outputs, b), outputs

    (want, (_, f_len, want_probs)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, variables["params"]))
    tb = {k: torch.from_numpy(v) for k, v in batch().items()}
    logits, got_len, probs = port(tb["audio"], tb["audio_len"])
    got = port_loss((logits, got_len, probs), tb)
    got.backward()
    got = got.detach()

    taps = cfg["encoder_params"]["interctc_blocks"]
    assert len(probs) == len(want_probs) == len(taps)
    for p, q in zip(probs, want_probs):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(q), rtol=0, atol=TOL)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(f_len))
    if case == "strided":       # the first tap scored past the final lengths
        assert probs[0].shape[1] > 2 * logits.shape[1]
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)
    want_g = params_from_jax(jax.tree.map(np.asarray, grads))
    for name, p in port.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        err = (g - want_g[name]).abs().max().item() / max(want_g[name].abs().max().item(), 1.0)
        assert err <= TOL, (name, err)
    tap_grads = [n for n, p in port.named_parameters()
                 if "linear_expand" in n and p.grad.abs().max() > 0]
    assert len(tap_grads) == 2 * len(taps)


def test_interctc_trainer_step():
    """The Trainer takes the InterCTC outputs (logits, lengths, taps): a
    finite loss equal to the eval-mode loss at dropout 0 before the step,
    the taps' parameters moved by it."""
    cfg = interctc_config(*CASES["strided"])
    trainer = Trainer(cfg, device="cpu")
    stacked = {k: v[None] for k, v in batch().items()}
    before = trainer.model.encoder.linear_expand_0.weight.detach().clone()
    loss, grad_norm = trainer.train_step(stacked)
    assert np.isfinite(float(loss)) and float(grad_norm) > 0
    assert not torch.equal(before, trainer.model.encoder.linear_expand_0.weight)


def test_interctc_without_taps_trains_as_ctc():
    """An InterCTC config with no interctc_blocks: the model returns an
    empty list of taps and the loss falls back to the main CTC loss, as
    the JAX package's does. Its Trainer step gives the loss and the
    weights of the same config's CTC step."""
    cfg = interctc_config(narrow_flagship(), [], 0.5)
    cfg["encoder_params"].pop("interctc_blocks")
    stacked = {k: v[None] for k, v in batch().items()}
    inter, ctc = Trainer(cfg, device="cpu"), Trainer(dict(cfg, model_type="CTC"), device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch().items()}
    with torch.no_grad():
        assert inter.model.eval()(tb["audio"], tb["audio_len"])[2] == []
    got, want = inter.train_step(stacked)[0], ctc.train_step(stacked)[0]
    assert np.isfinite(float(got))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    for (name, p), q in zip(inter.model.named_parameters(), ctc.model.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7, msg=name)
