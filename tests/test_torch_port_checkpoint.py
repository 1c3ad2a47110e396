"""PyTorch port vs the JAX package: checkpoints and SWA, on the CPU.

The port's checkpoint format round trip (bit for bit, with and without the
optimizer, the encoder alone into a Transducer), its SWA averages held to
the JAX package's over JAX states carried across by ``from_jax`` (<= 1e-6),
and a JAX checkpoint (JAX ``checkpoint.load`` -> ``from_jax`` +
``load_adam_state``) resumed in the port: its next step's loss and gradient
norm <= 1e-5 relative to JAX's resumed step. The model is tests/test_e2e.py's
TINY_ENC, in fp32 with dropout 0 and SpecAugment off (random masks cannot
match across frameworks).
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_e2e import make_config
from test_torch_port_data import make_flac_dataset

from efficientconformer_tpu.config import from_dict
from efficientconformer_tpu.runtime import example_microbatch
from efficientconformer_tpu.training import checkpoint as jax_checkpoint
from efficientconformer_tpu.training.trainer import Trainer as JaxTrainer
from efficientconformer_torch.data import datasets, loader, preparation
from efficientconformer_torch.training import checkpoint
from efficientconformer_torch.training.trainer import Trainer
from efficientconformer_torch.utils.weights import from_jax, load_adam_state

SWA_TOL = 1e-6
STEP_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the tiny models here: the test workers share
    the machine's cores, and contended threads slow small ops many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_config(tmp_path, root=None, model_type="CTC") -> dict:
    """tests/test_e2e.py's tiny config, fp32, dropout 0, SpecAugment off."""
    with open(make_config(root or str(tmp_path), tmp_path)) as f:
        cfg = json.load(f)
    cfg["encoder_params"].update(Pdrop=0.0, spec_augment=False)
    if model_type == "Transducer":
        cfg["model_type"] = "Transducer"
        cfg["decoder_params"] = {"arch": "RNN", "num_layers": 1, "dim_model": 16,
                                 "vocab_size": 48}
        cfg["joint_params"] = {"joint_mode": "sum", "dim_model": 16, "act": "tanh"}
    return cfg


def loader_batches(tmp_path, cfg, n=2):
    """``n`` training batches (2 x 2 utterances) of the prepared
    mini-LibriSpeech, as the CLI's loader gives them."""
    root = cfg["training_params"]["training_dataset_path"].rstrip("/")
    make_flac_dataset(root)
    tp, kp = cfg["training_params"], cfg["tokenizer_params"]
    preparation.prepare_dataset(tp, kp, preparation.create_tokenizer(tp, kp))
    ds = datasets.LibriSpeechDataset(root, "train", vocab_size=kp["vocab_size"])
    ld = loader.AsrBatchLoader(ds, tp["batch_size"], accum_steps=tp["accumulated_steps"])
    batches = [b for e in range(n) for b in ld.epoch(e)][:n]
    assert len(batches) == n
    return [{k: v for k, v in b.items() if k != "n_valid"} for b in batches]


def state_of(trainer: Trainer) -> dict:
    return copy.deepcopy({"model": trainer.model.state_dict(),
                          "optimizer": trainer.optimizer.state_dict(), "step": trainer.step})


def assert_same(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}/{i}")
    elif torch.is_tensor(want):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert torch.equal(got, want), path
    else:
        assert got == want, path


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    cfg = tiny_config(tmp_path, str(tmp_path / "LibriSpeech"))
    batch, batch2 = loader_batches(tmp_path, cfg)
    trainer = Trainer(cfg, device="cpu", seed=0)
    trainer.train_step(batch)
    path = str(tmp_path / "ckpt" / "checkpoints_1.ckpt")
    trainer.save(path)
    saved = state_of(trainer)
    assert not [f for f in os.listdir(tmp_path / "ckpt") if f.endswith(".tmp")]

    fresh = Trainer(cfg, device="cpu", seed=7)
    fresh.load(path)
    assert_same(state_of(fresh), saved)
    assert fresh.step == 1 and saved["optimizer"]["state"]
    # both take the same next step, bit for bit
    got, want = fresh.train_step(batch2), trainer.train_step(batch2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert_same(state_of(fresh), state_of(trainer))

    # without the optimizer: a template's optimizer state is kept
    trainer.save(path, save_optimizer=False)
    assert checkpoint.read(path)["optimizer"] is None
    template = Trainer(cfg, device="cpu", seed=7)
    template.train_step(batch)
    opt_before = copy.deepcopy(template.optimizer.state_dict())
    template.load(path)
    assert_same(template.optimizer.state_dict(), opt_before)
    assert_same(template.model.state_dict(), trainer.model.state_dict())
    assert template.step == trainer.step == 2


def test_load_encoder_takes_a_ctc_encoder_into_a_transducer(tmp_path):
    ctc = Trainer(tiny_config(tmp_path), device="cpu", seed=1)
    path = str(tmp_path / "ctc.ckpt")
    ctc.save(path)
    rnnt = Trainer(tiny_config(tmp_path, model_type="Transducer"), device="cpu", seed=2)
    before = copy.deepcopy(rnnt.model.state_dict())
    checkpoint.load_encoder(path, rnnt.model)
    after, src = rnnt.model.state_dict(), ctc.model.state_dict()
    for k, v in after.items():
        assert torch.equal(v, src[k] if k.startswith("encoder.") else before[k]), k
    with pytest.raises(KeyError, match="encoder entries"):
        checkpoint.load_encoder(path, Trainer(dict(tiny_config(tmp_path), encoder_params=dict(
            tiny_config(tmp_path)["encoder_params"], num_blocks=2, strided_blocks=[1],
            expand_blocks=[1], dim_model=[12, 16])), device="cpu").model)


def jax_states(cfg, n=3):
    """``n`` JAX states of the tiny model: the init, then parameters and
    BatchNorm statistics moved by seeded noise, steps 1..n."""
    jt = JaxTrainer(from_dict(cfg))
    base = jt.init_state(example_microbatch(from_dict(cfg)))
    states = []
    for i in range(n):
        rng = np.random.default_rng(i)

        def moved(x, scale):
            return jnp.asarray(np.asarray(x) + rng.standard_normal(x.shape).astype(np.float32)
                               * scale)
        states.append(base.replace(params=jax.tree.map(lambda x: moved(x, 0.1), base.params),
                                   batch_stats=jax.tree.map(lambda x: moved(x, 0.5) ** 2,
                                                            base.batch_stats),
                                   step=jnp.asarray(i + 1, jnp.int32)))
    return states


def port_checkpoint(state) -> dict:
    sd = from_jax({"params": jax.tree.map(np.asarray, state.params),
                   "batch_stats": jax.tree.map(np.asarray, state.batch_stats)})
    return {"model": sd, "optimizer": None, "step": int(state.step)}


@pytest.mark.parametrize("kind", ["equal", "exp"])
def test_swa_matches_jax(tmp_path, kind):
    cfg = tiny_config(tmp_path)
    states = jax_states(cfg)
    want = (jax_checkpoint.swa_average(states) if kind == "equal"
            else jax_checkpoint.swa_exp_average(states))
    names = [n for n, _ in Trainer(cfg, device="cpu").model.named_parameters()]
    ckpts = [port_checkpoint(s) for s in states]
    got = (checkpoint.swa_average(ckpts, names) if kind == "equal"
           else checkpoint.swa_exp_average(ckpts, names))
    want_sd = port_checkpoint(want)["model"]
    assert got["optimizer"] is None and got["step"] == 3
    assert got["model"].keys() == want_sd.keys()
    for k, v in want_sd.items():
        assert (got["model"][k] - v).abs().max().item() <= SWA_TOL, k
        if k not in names:       # BatchNorm buffers: the last state's
            assert torch.equal(got["model"][k], ckpts[-1]["model"][k]), k
    mean = sum(c["model"][names[0]] for c in ckpts) / 3
    assert kind != "equal" or torch.equal(got["model"][names[0]], mean)


def adam_of(opt_state):
    return next(s for s in opt_state if isinstance(s, optax.ScaleByAdamState))


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX run saves after one step; JAX resumes from the file and takes
    the next step, and the port, given the same file's state through
    from_jax and load_adam_state, takes the same step."""
    cfg = tiny_config(tmp_path, str(tmp_path / "LibriSpeech"))
    batch, batch2 = loader_batches(tmp_path, cfg)
    jcfg = from_dict(cfg)
    jt = JaxTrainer(jcfg)
    step_fn = jt.train_step_fn()
    rng = jax.random.PRNGKey(0)
    state, _ = step_fn(jt.init_state(example_microbatch(jcfg)),
                       {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    path = str(tmp_path / "jax.ckpt")
    jax_checkpoint.save(path, state)
    loaded = jax_checkpoint.load(path, jt.init_state(example_microbatch(jcfg)))
    adam = adam_of(loaded.opt_state)

    port = Trainer(cfg, device="cpu", seed=3)
    port.model.load_state_dict(from_jax({"params": jax.tree.map(np.asarray, loaded.params),
                                         "batch_stats": jax.tree.map(np.asarray,
                                                                     loaded.batch_stats)}))
    load_adam_state(port.optimizer, port.model, jax.tree.map(np.asarray, adam.mu),
                    jax.tree.map(np.asarray, adam.nu), adam.count)
    port.step = int(loaded.step)
    assert port.step == 1
    _, metrics = step_fn(loaded, {k: jnp.asarray(v) for k, v in batch2.items()}, rng)

    # through the port's own format too: save, load into a fresh trainer
    port_path = str(tmp_path / "port.ckpt")
    port.save(port_path)
    resumed = Trainer(cfg, device="cpu", seed=9)
    resumed.load(port_path)
    for trainer in (port, resumed):
        loss, grad_norm = trainer.train_step(batch2)
        np.testing.assert_allclose(float(loss), float(metrics["loss"]), rtol=STEP_RTOL)
        np.testing.assert_allclose(float(grad_norm), float(metrics["grad_norm"]),
                                   rtol=STEP_RTOL)
        assert trainer.step == int(loaded.step) + 1
