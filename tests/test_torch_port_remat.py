"""PyTorch port: activation recomputation (encoder_params["remat"]), on the
CPU in fp32.

First against the JAX package's remat in eval mode, as
tests/test_encoder.py::test_remat_gradients_match_no_remat holds the JAX
package's to its own encoder without remat: the loss and every gradient.
Then the port's two traps, which the JAX package, being functional, does
not have: in training mode, with dropout 0.1, SpecAugment and BatchNorm on
batch statistics, a step with remat "full" or "dots" gives the loss,
gradients, BatchNorm running statistics and generator state of the step
without it, so the recompute draws the forward's dropout masks, updates no
statistics a second time, and leaves the generator where the step without
remat leaves it. A Transducer with variational noise on its prediction and
joint networks steps alike, the noise still on the weights when the
backward recomputes.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from efficientconformer_tpu.models.encoders import ConformerEncoder as JaxEncoder
from efficientconformer_torch.models.encoders import ConformerEncoder
from efficientconformer_torch.training.trainer import Trainer
from efficientconformer_torch.utils.weights import from_jax, params_from_jax
from test_torch_port_training import train_batch, train_config
from test_torch_port_variants import jit_init, perturbed
from tests.test_encoder import TINY

LOSS_RTOL = 1e-6    # tests/test_encoder.py's bound on remat vs no remat
GRAD_RTOL = 1e-5


def jax_remat_loss_and_grads(params):
    """The JAX encoder's eval-mode loss sum(out^2) * 1e-3 and its gradients
    in every variable, under ``params``'s remat, from one seed (variables
    drawn with numpy, norms and BatchNorm statistics perturbed)."""
    x = jnp.array(np.random.default_rng(5).standard_normal((2, 3200)), jnp.float32)
    x_len = jnp.array([3200, 2400])
    enc = JaxEncoder(params=params)
    variables = perturbed(jit_init(enc, 0, x, x_len), 1)

    def loss_fn(v):
        out, _, _ = enc.apply(v, x, x_len, False)
        return jnp.sum(out ** 2) * 1e-3

    val, grad = jax.jit(jax.value_and_grad(loss_fn))(variables)
    return variables, float(val), grad, np.asarray(x), np.asarray(x_len)


def encoder_state(tree) -> dict:
    """The JAX encoder's variables (or a tree shaped like them) -> the port
    encoder's state."""
    sd = from_jax({"params": {"encoder": tree["params"]},
                   "batch_stats": {"encoder": tree.get("batch_stats", {})}})
    return {k.removeprefix("encoder."): v for k, v in sd.items()}


# tests/test_encoder.py's TINY cut to two stages of three blocks, which
# keeps a strided, an expanding and a grouped block and halves JAX's compile
REMAT_ENC = dict(TINY, num_blocks=3, dim_model=[16, 24], strided_blocks=[1],
                 expand_blocks=[1], att_group_size=[3, 1])


@pytest.mark.parametrize("remat", ["dots", True])
def test_remat_matches_jax_remat(remat):
    params = dict(REMAT_ENC, remat=remat)
    variables, want_val, want_grad, x, x_len = jax_remat_loss_and_grads(params)
    port = ConformerEncoder(params)
    port.load_state_dict(encoder_state(variables), strict=True)
    port.eval()
    out, _ = port(torch.from_numpy(x), torch.from_numpy(x_len))
    val = (out ** 2).sum() * 1e-3
    val.backward()
    assert abs(val.item() - want_val) <= LOSS_RTOL * max(1.0, abs(want_val))
    want = {k.removeprefix("encoder."): v for k, v in
            params_from_jax({"encoder": want_grad["params"]}).items()}
    for name, p in port.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        torch.testing.assert_close(g, want[name], rtol=GRAD_RTOL, atol=1e-6, msg=name)


def step_state(trainer: Trainer):
    """What a step leaves: the weights, the BatchNorm statistics and the
    generator's state."""
    return ({k: v.clone() for k, v in trainer.model.state_dict().items()},
            trainer.generator.get_state().clone())


def grads_after_step(cfg, batch):
    """(loss, every parameter's gradient, the state the step leaves) of one
    step of a fresh trainer: the gradients are kept by running the
    step's forward and backward under the trainer, with the optimizer's
    update, so the weights after the step are compared too."""
    trainer = Trainer(cfg, device="cpu", seed=0)
    grads = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, name=name: grads.__setitem__(name, p.grad.clone()))
        for name, p in trainer.model.named_parameters()]
    loss, grad_norm = trainer.train_step(batch)
    for h in hooks:
        h.remove()
    return loss.item(), grad_norm.item(), grads, step_state(trainer)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_step_in_training_mode_matches_no_remat(remat):
    """Dropout 0.1, SpecAugment on, BatchNorm updating: the same loss,
    gradients, weights, running statistics and generator state after one
    step (two microbatches) with remat as without."""
    cfg = train_config()
    cfg["encoder_params"].update(Pdrop=0.1, spec_augment=True)
    with_remat = copy.deepcopy(cfg)
    with_remat["encoder_params"]["remat"] = remat
    batch = train_batch(seed=3)
    want = grads_after_step(cfg, batch)
    got = grads_after_step(with_remat, batch)
    assert got[0] == pytest.approx(want[0], rel=1e-6)
    assert got[1] == pytest.approx(want[1], rel=1e-5)
    assert got[2].keys() == want[2].keys()
    for name in want[2]:
        torch.testing.assert_close(got[2][name], want[2][name], rtol=1e-5, atol=1e-7, msg=name)
    (got_sd, got_gen), (want_sd, want_gen) = got[3], want[3]
    for name in want_sd:    # weights after the update, and the running statistics
        torch.testing.assert_close(got_sd[name], want_sd[name], rtol=1e-5, atol=1e-7, msg=name)
    assert any("running_mean" in k for k in want_sd)
    assert torch.equal(got_gen, want_gen)


def test_remat_transducer_with_variational_noise_matches_no_remat():
    """A Transducer step with variational noise on from step 0 and dropout
    0.1: remat "full" gives the step without it."""
    from test_torch_port_transducer import train_config as t_train_config
    from test_torch_port_transducer import train_batch as t_train_batch

    cfg = t_train_config(vn_std=0.075, vn_start_step=0)
    cfg["encoder_params"].update(Pdrop=0.1)
    with_remat = copy.deepcopy(cfg)
    with_remat["encoder_params"]["remat"] = "full"
    batch = t_train_batch(seed=4)
    want = grads_after_step(cfg, batch)
    got = grads_after_step(with_remat, batch)
    assert got[0] == pytest.approx(want[0], rel=1e-6)
    for name in want[2]:
        torch.testing.assert_close(got[2][name], want[2][name], rtol=1e-5, atol=1e-7, msg=name)
    assert torch.equal(got[3][1], want[3][1])


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat"):
        ConformerEncoder(dict(TINY, remat="some"))
