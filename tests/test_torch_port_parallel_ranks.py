"""PyTorch port: data parallelism on the CPU, over gloo ranks spawned by
parallel/mesh.launch.

The globally synced BatchNorm over two ranks against one BatchNorm over the
concatenated batch (outputs, input and weight gradients, running
statistics); the generators (the variational noise the same on every rank,
dropout masks not); a step with the encoder frozen; DDP at one rank bit for
bit the step without it; the CLI with ``--cpu -d --world_size 2`` training
on the mini-LibriSpeech, its checkpoint loading at one rank; and
``python -m efficientconformer_torch.dryrun``. The functions the ranks run
live here or in the package, so a rank imports neither JAX nor the JAX
package: this module imports only the port at its top. Every launch has
its own timeout; each rank runs one intra-op thread.
"""

import copy
import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from efficientconformer_torch import dryrun
from efficientconformer_torch.config import load_config
from efficientconformer_torch.models.layers import BatchNorm1d, BatchNorm2d, Dropout
from efficientconformer_torch.parallel import mesh
from efficientconformer_torch.training.trainer import Trainer

RANK_TIMEOUT = 120   # seconds for a launch of two ranks
BN_TOL = 1e-5        # fp32 statistics summed in another order and from E[x^2] - E[x]^2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_jobs(jobs):
    """In a rank: each (function, args) of ``jobs`` in turn; their results."""
    return [fn(*args) for fn, args in jobs]


def launch_jobs(jobs, world=2):
    return mesh.launch(run_jobs, world, (jobs,), device_type="cpu", threads=1,
                       timeout=RANK_TIMEOUT)


# ---------------------------------------------------------------- the rank side


def bn_case(kind, seed=0):
    """A BatchNorm of 6 channels with weights off their defaults, a global
    batch of 4 (B, C, T[, F]) and the gradient of its output."""
    gen = torch.Generator().manual_seed(seed)
    shape = (4, 6, 9) if kind == 1 else (4, 6, 5, 3)
    bn = (BatchNorm1d if kind == 1 else BatchNorm2d)(6)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=gen)
        bn.bias.uniform_(-0.5, 0.5, generator=gen)
    x = torch.randn(shape, generator=gen) * 2 + 0.5
    return bn.train(), x, torch.randn(shape, generator=gen)


def bn_rank(kind):
    """This rank's half of the batch through the BatchNorm, twice (so the
    running statistics move twice): outputs, input gradient, the weight and
    bias gradients of this rank's loss, the running statistics."""
    bn, x, dy = bn_case(kind)
    mesh.all_reduce_sum.calls = 0
    rows = slice(2 * mesh.rank(), 2 * mesh.rank() + 2)
    x = x[rows].clone().requires_grad_()
    y = bn(x)
    (y * dy[rows]).sum().backward()
    bn(x.detach())
    return {"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad, "db": bn.bias.grad,
            "mean": bn.running_mean.clone(), "var": bn.running_var.clone(),
            "calls": mesh.all_reduce_sum.calls}


def streams_config() -> dict:
    """The shrunk flagship as a Transducer with small prediction and joint
    networks, variational noise from step 0 and dropout on."""
    cfg = dryrun.tiny_config()
    t = load_config(os.path.join(ROOT, "configs/EfficientConformerTransducerSmall.json"))
    cfg["model_type"] = "Transducer"
    cfg["decoder_params"] = dict(t["decoder_params"], dim_model=16, vocab_size=8)
    cfg["joint_params"] = dict(t["joint_params"], dim_model=16)
    cfg["tokenizer_params"]["vocab_size"] = 8
    cfg["encoder_params"].update(Pdrop=0.1)
    cfg["training_params"].update(vn_start_step=0, vn_std=0.075)
    return cfg


def stream_batch() -> dict:
    rng = np.random.default_rng(3)
    return {"audio": (rng.standard_normal((1, 4, 16000)) * 0.1).astype(np.float32),
            "audio_len": np.full((1, 4), 16000, np.int32),
            "labels": rng.integers(1, 8, (1, 4, 3)).astype(np.int32),
            "label_len": np.array([[3, 2, 3, 1]], np.int32)}


def streams_rank(cfg, batch):
    """One DDP step with variational noise and dropout on: the noise the
    prediction network's first layer saw, and the keep-mask of the
    encoder's first dropout."""
    trainer = Trainer(cfg, device="cpu")
    seen = {}
    vn_layer = next(m for m in trainer.model.decoder.modules() if getattr(m, "vn_std", None))
    drop = next(m for m in trainer.model.encoder.modules() if isinstance(m, Dropout) and m.p)

    def noise(m, i, o):
        seen.setdefault("noise", {k: v.clone() for k, v in m.vn_noise.items()})

    def keep(m, i, o):
        seen.setdefault("keep", (o != 0) | (i[0] == 0))

    vn_layer.register_forward_hook(noise)
    drop.register_forward_hook(keep)
    loss, _ = trainer.train_step(mesh.shard_batch(
        {k: torch.as_tensor(v) for k, v in batch.items()}))
    return {"noise": seen["noise"], "keep": seen["keep"], "loss": float(loss),
            "params": {n: p.detach().clone() for n, p in trainer.model.named_parameters()}}


def frozen_rank(cfg, batch):
    """Two steps with encoder_frozen_steps 0: the first with the encoder
    frozen, the second not. The encoder after each, and the losses."""
    cfg = copy.deepcopy(cfg)
    cfg["training_params"]["encoder_frozen_steps"] = 0
    trainer = Trainer(cfg, device="cpu")
    mine = mesh.shard_batch({k: torch.as_tensor(v) for k, v in batch.items()})

    def encoder():
        return {n: p.detach().clone() for n, p in trainer.model.encoder.named_parameters()}

    before = encoder()
    losses = [float(trainer.train_step(mine)[0])]
    frozen = encoder()
    losses.append(float(trainer.train_step(mine)[0]))
    return {"before": before, "frozen": frozen, "after": encoder(), "losses": losses}


def evaluate_rank(cfg, ckpt, split, batch_size):
    """``runtime.evaluate`` of the checkpoint ``ckpt`` over ``split`` of the
    config's evaluation data, in this rank: (WER, truths, predictions, eval
    loss)."""
    from efficientconformer_torch import runtime
    from efficientconformer_torch.data import datasets

    trainer = Trainer(cfg, device="cpu")
    trainer.load(ckpt)
    ds = datasets.LibriSpeechDataset(cfg["training_params"]["evaluation_dataset_path"], split,
                                     vocab_size=cfg["tokenizer_params"]["vocab_size"])
    return runtime.evaluate(trainer, ds, runtime.load_tokenizer(cfg), batch_size=batch_size,
                            eval_loss=True)


# ---------------------------------------------------------------- the tests


@pytest.fixture(scope="module")
def ranked():
    """Every rank-side case above, run once in one launch of two ranks."""
    cfg, batch = streams_config(), stream_batch()
    outs = launch_jobs([(bn_rank, (1,)), (bn_rank, (2,)), (streams_rank, (cfg, batch)),
                        (frozen_rank, (cfg, batch))])
    return {name: [o[i] for o in outs]
            for i, name in enumerate(("bn1", "bn2", "streams", "frozen"))}


@pytest.mark.parametrize("kind", [1, 2])
def test_synced_batch_norm_equals_one_batch_norm_over_both_halves(ranked, kind):
    """(e) Two ranks' halves through the synced BatchNorm: outputs and input
    gradients the one-process BatchNorm's over the whole batch, the weight
    and bias gradients summed over the ranks its gradients, the running
    statistics equal to its and bit for bit equal across the ranks; three
    all-reduces a rank: two forwards and one backward."""
    got = ranked[f"bn{kind}"]
    bn, x, dy = bn_case(kind)
    x = x.clone().requires_grad_()
    y = bn(x)
    (y * dy).sum().backward()
    bn(x.detach())
    torch.testing.assert_close(torch.cat([g["y"] for g in got]), y.detach(), rtol=0, atol=BN_TOL)
    torch.testing.assert_close(torch.cat([g["dx"] for g in got]), x.grad, rtol=0, atol=BN_TOL)
    torch.testing.assert_close(got[0]["dw"] + got[1]["dw"], bn.weight.grad, rtol=0, atol=BN_TOL)
    torch.testing.assert_close(got[0]["db"] + got[1]["db"], bn.bias.grad, rtol=0, atol=BN_TOL)
    for k, want in (("mean", bn.running_mean), ("var", bn.running_var)):
        torch.testing.assert_close(got[0][k], want, rtol=0, atol=BN_TOL)
        assert torch.equal(got[0][k], got[1][k]), k
    assert [g["calls"] for g in got] == [3, 3]


def test_variational_noise_is_shared_and_dropout_is_not(ranked):
    """(f) With VN on, both ranks add the same noise to the prediction
    network; the dropout masks of the two ranks differ; the step ends with
    the same loss and parameters on both."""
    a, b = ranked["streams"]
    assert a["noise"].keys() == b["noise"].keys() and a["noise"]
    for k in a["noise"]:
        assert torch.equal(a["noise"][k], b["noise"][k]), k
    assert a["keep"].shape == b["keep"].shape and not torch.equal(a["keep"], b["keep"])
    assert a["loss"] == b["loss"] and math.isfinite(a["loss"])
    for n in a["params"]:
        assert torch.equal(a["params"][n], b["params"][n]), n


def test_frozen_encoder_steps_under_ddp(ranked):
    """(g) With encoder_frozen_steps, the DDP step neither fails nor hangs:
    the frozen step leaves the encoder as it was on both ranks, the next
    moves it, equally on both."""
    a, b = ranked["frozen"]
    for n in a["before"]:
        assert torch.equal(a["frozen"][n], a["before"][n]), n
        assert torch.equal(a["after"][n], b["after"][n]), n
    assert any(not torch.equal(a["after"][n], a["before"][n]) for n in a["before"])
    assert a["losses"] == b["losses"] and all(math.isfinite(x) for x in a["losses"])


def test_ddp_at_one_rank_is_the_step_without_it():
    """(d) DDP in a process group of one rank (gloo), over two accumulated
    microbatches with dropout and SpecAugment on: the loss, the gradient
    norm, the parameters, the gradients and the buffers are bit for bit
    those of the trainer without DDP (the same streams at one rank)."""
    cfg = dryrun.tiny_config()
    cfg["encoder_params"].update(Pdrop=0.1)
    cfg["training_params"]["accumulated_steps"] = 2
    one = dryrun.example_batch(4, 8)
    batch = {k: v.reshape((2, 2) + v.shape[2:]) for k, v in one.items()}
    with mesh.process_group(0, 1, "cpu"):
        got = dryrun.shard_step(cfg, batch, device="cpu", ddp=True, steps=2, grads=True)
    want = dryrun.shard_step(cfg, batch, device="cpu", ddp=False, steps=2, grads=True)
    assert got["ddp"] and not want["ddp"] and got["world"] == 1
    assert got["loss"] == want["loss"] and got["grad_norm"] == want["grad_norm"]
    for key in ("params", "grads", "buffers"):
        for n, w in want[key].items():
            assert torch.equal(got[key][n], w), (key, n)
    assert got["ddp_all_reduces"] >= 2 and got["bn_all_reduces"] == 0


def test_cli_trains_on_two_gloo_ranks(tmp_path):
    """``python -m efficientconformer_torch.main --cpu -d --world_size 2 -m
    training`` on the mini-LibriSpeech: one epoch line, one validation line,
    one checkpoint, written from the unwrapped model, which loads at one
    rank."""
    from test_torch_port_checkpoint import tiny_config
    from test_torch_port_runtime import prepare

    root = str(tmp_path / "LibriSpeech")
    cfg = tiny_config(tmp_path, root)
    prepare(root, cfg)
    cfg["training_params"].update(epochs=1, callback_path=str(tmp_path / "cb") + "/")
    path = tmp_path / "ctc.json"
    path.write_text(json.dumps(cfg))
    res = subprocess.run([sys.executable, "-m", "efficientconformer_torch.main", "--cpu", "-c",
                          str(path), "-d", "--world_size", "2", "-m", "training",
                          "--steps_per_epoch", "2", "--val_steps", "1", "--batch_size_eval", "2"],
                         cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=RANK_TIMEOUT)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    out = res.stdout
    epochs = re.findall(r"epoch (\d+)/1 loss (\S+) \([\d.]+s, (\d+) steps", out)
    assert len(epochs) == 1 and epochs[0][2] == "2" and math.isfinite(float(epochs[0][1])), out
    assert len(re.findall(r"val: \{'WER'", out)) == 1, out
    assert out.count("Model Parameters :") == 1, out
    assert [f for f in os.listdir(tmp_path / "cb") if f.endswith(".ckpt")] == \
        ["checkpoints_1.ckpt"]
    saved = torch.load(tmp_path / "cb" / "checkpoints_1.ckpt", weights_only=False)
    assert not any(k.startswith("module.") for k in saved["model"])
    trainer = Trainer(cfg, device="cpu")
    trainer.load(str(tmp_path / "cb" / "checkpoints_1.ckpt"))
    assert trainer.step == 2


def test_dryrun_multichip_prints_its_all_reduces():
    """``python -m efficientconformer_torch.dryrun 2 --cpu`` in a fresh
    process: one step of the shrunk flagship over two gloo ranks, equal on
    both, printing DDP's gradient all-reduces (one bucket) and BatchNorm's
    (6 layers: 6 forward, 6 backward); nothing of JAX, flax or the JAX
    package is loaded."""
    code = ("import sys; from efficientconformer_torch import dryrun; dryrun.main(['2', '--cpu']); "
            "print('LOADED', sorted(m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib', 'flax', 'efficientconformer_tpu'))))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=RANK_TIMEOUT, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "dryrun_multichip ok (data parallel over 2 cpu rank(s))" in res.stdout
    assert ("all-reduces: {'ddp_gradient_buckets': 1, 'batch_norm_statistics': 12}"
            in res.stdout), res.stdout
    assert "grid: {'data': 2, 'seq': 1, 'model': 1}" in res.stdout, res.stdout
    assert "LOADED []" in res.stdout, res.stdout


def test_dryrun_multichip_runs_data_seq_model_at_8():
    """``python -m efficientconformer_torch.dryrun 8 --cpu``: data 2 x seq 2
    x model 2, as ``__graft_entry__.dryrun_multichip`` meshes 8 devices, on
    20160-sample utterances, equal on every rank, printing the grid and
    every group's collectives: DDP's one bucket over the data x seq group,
    BatchNorm's 12, the model groups' all-reduces and all-gathers and the
    seq groups' all-gathers, halos and reduce-scatters."""
    code = "from efficientconformer_torch import dryrun; dryrun.main(['8', '--cpu'])"
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=RANK_TIMEOUT, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "dryrun_multichip ok (data 2 x seq 2 x model 2 over 8 cpu rank(s))" in res.stdout
    assert "grid: {'data': 2, 'seq': 2, 'model': 2}" in res.stdout, res.stdout
    assert ("all-reduces: {'ddp_gradient_buckets': 1, 'batch_norm_statistics': 12}"
            in res.stdout), res.stdout
    seq = re.search(r"seq group: \{'all_gather': (\d+), 'halo': (\d+), 'reduce_scatter': "
                    r"(\d+), 'all_reduce': 0\}", res.stdout)
    model = re.search(r"model group: \{'all_reduce': (\d+), 'all_gather': (\d+)\}",
                      res.stdout)
    assert seq and model, res.stdout
    assert all(int(n) > 0 for n in seq.groups() + model.groups()), res.stdout


def test_dryrun_without_a_card_raises():
    """The dry run's default device is the card: without one it raises,
    rather than run on the CPU (--cpu asks for that)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(2)


def test_parallel_flags_refuse_what_the_machine_lacks():
    """On the card, more ranks than GPUs raise before any rank starts (this
    machine has none: so does one); gloo lets ranks share a card; the CPU
    takes any count."""
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="visible"):
            mesh.check_world_size(torch.cuda.device_count() + 1, "cuda")
        mesh.check_world_size(torch.cuda.device_count() + 1, "cuda", "gloo")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.check_world_size(1, "cuda")
    mesh.check_world_size(3, "cpu")
    with pytest.raises(ValueError):
        mesh.check_world_size(0, "cpu")
    batch = {"a": np.arange(12).reshape(2, 6), "n": np.arange(2)}
    halves = [mesh.shard_batch(batch, r, 3) for r in range(3)]
    np.testing.assert_array_equal(np.concatenate([h["a"] for h in halves], axis=1), batch["a"])
    assert all(h["n"] is batch["n"] for h in halves)
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_batch(batch, 0, 4)
