"""PyTorch port vs the JAX package: data parallelism, on the CPU.

One step of two gloo ranks of the port (parallel/mesh.launch; each rank
runs dryrun.shard_step on its half of every microbatch, under DDP with the
globally synced BatchNorm) against the JAX package's Trainer on a 2-device
CPU mesh over the same global batch (``mesh_lib.make_mesh(jax.devices()[:2])``
and ``shard_batch``, as ``__graft_entry__.py:84-126``), from the same
weights and the same non-zero Adam state: the narrowed flagship (CTC), a
narrowed Transducer (the RNN-T plain version on the CPU) and a narrowed
LM-Transformer over ragged sequences, so that the two ranks hold different
numbers of targets. Loss and global gradient norm within LOSS_RTOL, the
updated parameters within PARAM_TOL, BatchNorm's running statistics within
DP_STATS_TOL of the float64 statistics of the global batch and STATS_TOL of
JAX's (flax's fp32 statistics lie up to 4.5e-6 from the float64 ones at the
flagship's subsampling, so 1e-6 of JAX's would hold the port to JAX's
rounding). Then ``runtime.evaluate`` at two ranks against one rank and
JAX's ``evaluate``. Dropout 0 and SpecAugment off, since random masks cannot
match across frameworks. The ranks' work runs in one launch, whose functions
import nothing of JAX.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_checkpoint import tiny_config
from test_torch_port_lm import lm_batch, lm_config
from test_torch_port_parallel_ranks import evaluate_rank, launch_jobs
from test_torch_port_runtime import both, datasets_of, prepare
from test_torch_port_training import (LOSS_RTOL, PARAM_TOL, STATS_TOL, adam_moments,
                                      rel_err, train_config, with_adam_state)
from test_torch_port_transducer import VOCAB as T_VOCAB
from test_torch_port_transducer import train_config as t_train_config

from efficientconformer_tpu import runtime as jax_runtime
from efficientconformer_tpu.config import from_dict
from efficientconformer_tpu.data.tokenizer import BpeTokenizer as JaxBpeTokenizer
from efficientconformer_tpu.parallel import mesh as mesh_lib
from efficientconformer_tpu.training.trainer import Trainer as JaxTrainer
from efficientconformer_tpu.training.trainer import TrainerState
from efficientconformer_tpu.utils import torch_compat as TC
from efficientconformer_torch import dryrun, runtime
from efficientconformer_torch.data.tokenizer import BpeTokenizer
from efficientconformer_torch.models import factory
from efficientconformer_torch.models.layers import _BatchNorm
from efficientconformer_torch.training.trainer import Trainer
from efficientconformer_torch.utils.weights import from_jax, params_from_jax

DP_STATS_TOL = 1e-6   # BatchNorm running statistics vs float64, relative to max(|x|, 1)
ADAM_COUNT = 10


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def asr_batch(vocab, seed=0):
    """Two stacked microbatches of 4 ragged utterances, a label-free one
    among them: 2 a rank."""
    rng = np.random.default_rng(seed)
    a, b, t, u = 2, 4, 12000, 4
    audio = (rng.standard_normal((a, b, t)) * 0.1).astype(np.float32)
    audio_len = np.array([[12000, 9000, 7000, 10000], [11000, 12000, 6000, 8000]], np.int32)
    audio[np.arange(t)[None, None] >= audio_len[..., None]] = 0.0
    labels = rng.integers(1, vocab, (a, b, u)).astype(np.int32)
    label_len = np.array([[4, 2, 0, 3], [3, 4, 1, 2]], np.int32)
    labels[np.arange(u)[None, None] >= label_len[..., None]] = 0
    return {"audio": audio, "audio_len": audio_len, "labels": labels, "label_len": label_len}


def dp_lm_batch():
    """Two stacked microbatches of 4 ragged sequences: rank 0 holds 10 + 9
    tokens, rank 1 7 + 13."""
    mbs = [lm_batch([7, 3, 5, 2], 7, 5), lm_batch([2, 7, 6, 7], 7, 6)]
    return {k: np.stack([mb[k] for mb in mbs]) for k in mbs[0]}


def jax_mesh_step(cfg, params, stats, batch):
    """JAX's step on a 2-device CPU mesh, the batch sharded over it, from
    ``params`` and the Adam state of ``adam_moments(params)``."""
    mesh = mesh_lib.make_mesh(jax.devices()[:2])
    jt = JaxTrainer(from_dict(cfg), mesh=mesh)
    jparams = jax.tree.map(jnp.asarray, params)
    mu, nu = adam_moments(params)
    state = TrainerState(params=jparams, batch_stats=jax.tree.map(jnp.asarray, stats),
                         opt_state=with_adam_state(jt.tx.init(jparams), mu, nu, ADAM_COUNT),
                         step=jnp.asarray(ADAM_COUNT, jnp.int32))
    sharded = mesh_lib.shard_batch(mesh, batch, batch_axis=1)
    return jt.train_step_fn()(state, sharded, jax.random.PRNGKey(0))


def float64_stats(cfg, batch) -> dict:
    """The running statistics after the step, in float64: every BatchNorm's
    inputs over each global microbatch of a one-process forward of the same
    seeded weights (the step's forwards see the weights from before it),
    then the flax update (momentum 0.9, biased variance)."""
    port = Trainer(cfg, device="cpu", seed=0)
    norms = {n: m for n, m in port.model.named_modules() if isinstance(m, _BatchNorm)}
    stats = {f"{n}.running_{k}": getattr(m, f"running_{k}").double().clone()
             for n, m in norms.items() for k in ("mean", "var")}
    for n, m in norms.items():
        def update(m, inputs, n=n):
            x = inputs[0].detach().double()
            var, mean = torch.var_mean(x, dim=[0] + list(range(2, x.dim())), correction=0)
            for k, v in (("mean", mean), ("var", var)):
                stats[f"{n}.running_{k}"] = 0.9 * stats[f"{n}.running_{k}"] + 0.1 * v
        m.register_forward_pre_hook(update)
    with torch.no_grad():
        for mb, _ in port._microbatches({k: torch.as_tensor(v) for k, v in batch.items()}):
            factory.apply_model(port.model, mb, True, port.generator)
    return stats


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Each case's config, batch, JAX weights and step, float64 statistics,
    and the ranks' results: the ranks' four jobs run in one launch of two
    ranks while JAX compiles its steps here."""
    out = {}
    cfg = train_config()
    port = Trainer(cfg, device="cpu", seed=0)
    out["ctc"] = (cfg, asr_batch(cfg["tokenizer_params"]["vocab_size"]),
                  *(jax.tree.map(np.array, t) for t in TC.convert_ctc(port.model.state_dict())))
    cfg = t_train_config()
    port = Trainer(cfg, device="cpu", seed=0)
    out["transducer"] = (cfg, asr_batch(T_VOCAB, seed=1), *(
        jax.tree.map(np.array, t) for t in TC.convert_transducer(port.model.state_dict())))
    cfg, batch = lm_config(), dp_lm_batch()
    state = JaxTrainer(from_dict(cfg)).init_state(jax.tree.map(lambda x: jnp.asarray(x[0]), batch))
    out["lm"] = (cfg, batch, jax.tree.map(np.asarray, state.params), {})
    jobs = []
    for name, (cfg, batch, params, stats) in out.items():
        # the LM's weights are JAX's draw; the others' the port's seeded one
        weights = from_jax({"params": params}) if name == "lm" else None
        mu, nu = (params_from_jax(t) for t in adam_moments(params))
        jobs.append((dryrun.shard_step, (cfg, batch, 0, (mu, nu, ADAM_COUNT), None, 1, None,
                                         weights)))

    tmp = tmp_path_factory.mktemp("dp_eval")
    root = str(tmp / "LibriSpeech")
    cfg = tiny_config(tmp, root)
    prepare(root, cfg)
    jt, state, port = both(cfg, seed=4)
    port.save(str(tmp / "eval.ckpt"))
    jobs.append((evaluate_rank, (cfg, str(tmp / "eval.ckpt"), "test-clean", 6)))
    with ThreadPoolExecutor(1) as pool:
        launched = pool.submit(launch_jobs, jobs)
        steps = {name: (jax_mesh_step(cfg_, params, stats, batch),
                        float64_stats(cfg_, batch) if stats else None)
                 for name, (cfg_, batch, params, stats) in out.items()}
        path = cfg["tokenizer_params"]["tokenizer_path"]
        ds, jds = datasets_of(cfg, "test-clean")
        one = runtime.evaluate(port, ds, BpeTokenizer.load(path), batch_size=6, eval_loss=True)
        want = jax_runtime.evaluate(jt, state, jds, JaxBpeTokenizer.load(path), batch_size=6,
                                    eval_loss=True)
        ranks = launched.result()
    results = {name: [r[i] for r in ranks] for i, name in enumerate(["ctc", "transducer", "lm"])}
    results["eval"] = ([r[3] for r in ranks], one, want)
    return steps, results


@pytest.mark.parametrize("case", ["ctc", "transducer", "lm"])
def test_dp_step_matches_jax_mesh(cases, case):
    """(a) the narrowed flagship, (b) a narrowed Transducer, (c) the
    narrowed LM-Transformer: one accumulated Adam step (A = 2) of two ranks
    (2 rows each a microbatch) against JAX's step on a 2-device mesh over
    the 4-row global microbatches: the loss and the global gradient norm,
    the same on both ranks; the updated parameters, bit for bit equal across
    the ranks; BatchNorm's running statistics: the global batch's, bit for
    bit equal across the ranks, within DP_STATS_TOL of float64 and
    STATS_TOL of JAX's."""
    steps, results = cases
    (new, metrics), exact = steps[case]
    got = results[case]
    for r in got:
        assert r["world"] == 2 and r["ddp"] and r["ddp_all_reduces"] >= 1
        np.testing.assert_allclose(r["loss"], float(metrics["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["grad_norm"], float(metrics["grad_norm"]), rtol=LOSS_RTOL)
    assert got[0]["loss"] == got[1]["loss"] and got[0]["grad_norm"] == got[1]["grad_norm"]
    want = params_from_jax(jax.tree.map(np.asarray, new.params))
    for name, p in got[0]["params"].items():
        torch.testing.assert_close(p, want[name], rtol=0, atol=PARAM_TOL, msg=name)
        assert torch.equal(p, got[1]["params"][name]), name
    if case == "lm":
        assert got[0]["bn_all_reduces"] == 0
        return
    # BatchNorm: every layer all-reduces once a forward and once a backward
    n_bn = sum(1 for k in got[0]["buffers"] if k.endswith("running_mean"))
    assert got[0]["bn_all_reduces"] == 2 * 2 * n_bn > 0
    want_stats = from_jax({"params": jax.tree.map(np.asarray, new.params),
                           "batch_stats": jax.tree.map(np.asarray, new.batch_stats)})
    assert len(exact) == 2 * n_bn
    for name, want_ in exact.items():
        b = got[0]["buffers"][name]
        assert rel_err(b.double(), want_) <= DP_STATS_TOL, name
        assert rel_err(b, want_stats[name]) <= STATS_TOL, name
        assert torch.equal(b, got[1]["buffers"][name]), name


def test_two_rank_evaluate_matches_one_rank_and_jax(cases):
    """test-clean's 4 utterances in one batch of 6: rank 0 decodes 3 of
    them, rank 1 the fourth and two repeats, which it drops (n_valid); the
    gathered truths and predictions, the WER and the eval loss equal the
    one-rank evaluate's and JAX's ``evaluate``'s, on every rank."""
    ranks, one, want = cases[1]["eval"]
    assert len(one[1]) == 4 and one[1] == want[1] and one[2] == want[2] and one[0] == want[0]
    for got in ranks:
        assert got[1] == one[1] and got[2] == one[2] and got[0] == one[0]
        np.testing.assert_allclose(got[3], one[3], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got[3], want[3], rtol=LOSS_RTOL)
