"""PyTorch port vs the JAX package: sequence parallelism, on the CPU.

The port's time-sharded step (parallel/sequence.py: the encoder's
activations split along time over seq groups of gloo ranks spawned by
parallel/mesh.launch, conv halos, keys and values gathered into the rel-pos
kernel's plain version at the rank's row offset, the grouped G = 3 stage
with 32 frames a rank, BatchNorm over data x seq) at data 1 x seq 2, data 2
x seq 2 and data 1 x seq 2 x model 2 against the JAX package's Trainer on
``make_mesh(jax.devices()[:2], seq_parallel=2)``, ``[:4]`` and ``[:4]``
with ``model_parallel=2`` (its parameters placed by ``shard_params``), from
the same weights and the same non-zero Adam state: the shrunk flagship of
``dryrun.TINY_ENCODER`` (CTC; the grouped stage, two strided expand
blocks) and a Transducer on that encoder, over 20160-sample batches (frame
schedule 64 / 32 / 16: every point divides by 2). Loss and global gradient
norm within LOSS_RTOL, the updated parameters within PARAM_TOL and the
BatchNorm running statistics within STATS_TOL of JAX's; the same steps
against the port's one-process step within ONE_TOL, the parameters bit for
bit equal across the ranks. Then a step with dropout, SpecAugment and
variational noise on, a batch length at which no point divides (the
coverage warning, and the step replicated), InterCTC taps, remat "full" and
a checkpoint round trip against the one-process step; the operators (a
depthwise conv's halo at stride 1 and 2 with odd offsets and with fewer
frames a rank than the halo, ``gather_time`` and ``split_time``, a grouped
attention layer whose groups straddle the ranks) against the whole layers;
and the planners against JAX's on every shipped ASR config at seq 2 and 4
(the layers this file's flagship does not reach: test_torch_port_sp_remainder.py).
Dropout 0 and SpecAugment off against JAX, since random masks
cannot match across frameworks. The ranks run in three launches
(tests/torch_sp_ranks.py, which imports nothing of JAX) while JAX compiles
its steps here.
"""

import glob
import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_parallel import ADAM_COUNT
from test_torch_port_tensor_parallel import (ONE_TOL, assert_matches_one_process, jax_params,
                                             port_adam, stats_of, tiny, vn_config)
from test_torch_port_training import (LOSS_RTOL, PARAM_TOL, STATS_TOL, adam_moments, rel_err,
                                      train_config, with_adam_state)
from test_torch_port_transducer import VOCAB as T_VOCAB
from test_torch_port_transducer import train_config as t_train_config
from torch_sp_ranks import (CONV_CASES, SP_SAMPLES, attention_case, checkpoint_rank,
                            conv_case, launch_jobs, operator_ranks, sp_step)

from efficientconformer_tpu.config import from_dict
from efficientconformer_tpu.data.loader import make_buckets
from efficientconformer_tpu.parallel import mesh as mesh_lib
from efficientconformer_tpu.training.trainer import Trainer as JaxTrainer
from efficientconformer_tpu.training.trainer import TrainerState
from efficientconformer_torch import dryrun
from efficientconformer_torch.parallel import mesh
from efficientconformer_torch.training.trainer import Trainer
from efficientconformer_torch.utils.weights import from_jax, params_from_jax

# data x seq (x model) -> (devices, model size)
GRIDS = {"1x2": (2, 1), "2x2": (4, 1), "1x2x2": (4, 2)}
# the gradient norm of a four-rank step against the one-process step: fp32 sums
# over the batch split four ways sit at this floor on these batches. JAX's own
# data-parallel steps over 2 and 4 devices lie 1.1e-6 and 1.8e-6 from its
# one-device step on the Transducer case, and the port's data 2 x model 2 step
# (tensor parallelism alone) 1.2e-6 from its one-process step
FOUR_RANK_NORM_TOL = 2e-6
UNCOVERED = SP_SAMPLES + 2 * 160   # 129 mel frames -> 65 -> 33 -> 17: no point divides by 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sp_batch(vocab, seed=0, samples=SP_SAMPLES):
    """Two stacked microbatches of 4 ragged utterances of at most
    ``samples`` samples, a label-free one among them."""
    rng = np.random.default_rng(seed)
    a, b, u = 2, 4, 4
    audio = (rng.standard_normal((a, b, samples)) * 0.1).astype(np.float32)
    audio_len = np.array([[samples, 15000, 11000, 18000], [17000, samples, 9000, 13000]],
                         np.int32)
    audio[np.arange(samples)[None, None] >= audio_len[..., None]] = 0.0
    labels = rng.integers(1, vocab, (a, b, u)).astype(np.int32)
    label_len = np.array([[4, 2, 0, 3], [3, 4, 1, 2]], np.int32)
    labels[np.arange(u)[None, None] >= label_len[..., None]] = 0
    return {"audio": audio, "audio_len": audio_len, "labels": labels, "label_len": label_len}


def configs() -> dict:
    """(config, global batch) of each case held to JAX."""
    return {"ctc": (tiny(train_config()), sp_batch(16)),
            "transducer": (tiny(t_train_config()), sp_batch(T_VOCAB, seed=1))}


def interctc_config() -> dict:
    cfg = tiny(train_config())
    cfg.update(model_type="InterCTC")
    cfg["encoder_params"]["interctc_blocks"] = [0, 1, 3]
    cfg["training_params"]["interctc_lambda"] = 0.5
    return cfg


def remat_config() -> dict:
    cfg = tiny(train_config())
    cfg["encoder_params"]["remat"] = "full"
    return cfg


def sp_vn_config() -> dict:
    """The Transducer with dropout 0.1, SpecAugment and variational noise
    from step 0: at one data rank the seq ranks draw what one process
    draws."""
    cfg = vn_config()
    cfg["encoder_params"].update(spec_augment=True)
    return cfg


def jax_sp_step(cfg, params, stats, batch, grid):
    """JAX's step on the (data, seq[, model]) mesh of ``grid`` ("dp": its
    data-parallel step over four devices), the parameters placed by
    ``shard_params`` and the batch sharded over the data axis, from
    ``params`` and the Adam state of ``adam_moments``."""
    devices, model = GRIDS.get(grid, (4, 1))
    mesh_ = mesh_lib.make_mesh(jax.devices()[:devices], model_parallel=model,
                               seq_parallel=1 if grid == "dp" else 2)
    jt = JaxTrainer(from_dict(cfg), mesh=mesh_)
    jparams = jax.tree.map(jnp.asarray, params)
    mu, nu = adam_moments(params)
    state = TrainerState(params=mesh_lib.shard_params(mesh_, jparams),
                         batch_stats=jax.tree.map(jnp.asarray, stats),
                         opt_state=with_adam_state(jt.tx.init(jparams), mu, nu, ADAM_COUNT),
                         step=jnp.asarray(ADAM_COUNT, jnp.int32))
    sharded = mesh_lib.shard_batch(mesh_, batch, batch_axis=1)
    new, metrics = jt.train_step_fn()(state, sharded, jax.random.PRNGKey(0))
    return (jax.tree.map(np.asarray, new.params), jax.tree.map(np.asarray, new.batch_stats),
            {k: float(v) for k, v in metrics.items()}, dict(mesh_.shape))


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Every case's JAX steps, the port's one-process steps and the ranks'
    results: launches of two ranks (seq 2) and of four (data 2 x seq 2, then
    seq 2 x model 2) run in a thread while JAX compiles here."""
    tmp = tmp_path_factory.mktemp("sp")
    setup, adams = {}, {}
    for name, (cfg, batch) in configs().items():
        params, stats = jax_params(name, cfg, batch)
        mu, nu = (params_from_jax(t) for t in adam_moments(params))
        adams[name] = (mu, nu, ADAM_COUNT)
        setup[name] = (cfg, batch, params, stats)
    extra = {"vn": (sp_vn_config(), sp_batch(T_VOCAB, seed=2)),
             "uncovered": (tiny(train_config()), sp_batch(16, seed=3, samples=UNCOVERED)),
             "interctc": (interctc_config(), sp_batch(16, seed=4)),
             "remat": (remat_config(), sp_batch(16, seed=5))}
    for name, (cfg, batch) in extra.items():
        adams[name] = port_adam(cfg)
    ctc_cfg, ctc_batch = setup["ctc"][:2]
    path_in, path_out = str(tmp / "one.ckpt"), str(tmp / "sp.ckpt")
    Trainer(ctc_cfg, device="cpu", seed=7).save(path_in)

    jobs2 = [(sp_step, (cfg, batch, adams[n])) for n, (cfg, batch, _, _) in setup.items()]
    jobs2 += [(sp_step, (cfg, batch, adams[n])) for n, (cfg, batch) in extra.items()]
    jobs2.append((checkpoint_rank, (ctc_cfg, ctc_batch, adams["ctc"], path_in, path_out)))
    jobs2.append((operator_ranks, ()))
    jobs_dp = [(sp_step, (cfg, batch, adams[n])) for n, (cfg, batch, _, _) in setup.items()]
    jobs_tp = [(sp_step, (cfg, batch, adams[n], None, 2, 2))
               for n, (cfg, batch, _, _) in setup.items()]

    def ranks():
        return [launch_jobs(jobs, world) for jobs, world in ((jobs2, 2), (jobs_dp, 4),
                                                             (jobs_tp, 4))]

    with ThreadPoolExecutor(1 + len(setup) * (len(GRIDS) + 1)) as pool:
        launched = pool.submit(ranks)
        steps = {(name, g): pool.submit(jax_sp_step, cfg, params, stats, batch, g)
                 for g in list(GRIDS) + ["dp"]
                 for name, (cfg, batch, params, stats) in setup.items()}
        # the port's one-process steps, here, while the ranks run and XLA compiles
        one = {name: dryrun.shard_step(cfg, batch, 0, adams[name], None, 1, "cpu", grads=True)
               for name, (cfg, batch) in [(n, v[:2]) for n, v in setup.items()] +
               list(extra.items())}
        steps = {k: f.result() for k, f in steps.items()}
        two, four_dp, four_tp = launched.result()
    got = {}
    for i, name in enumerate(setup):
        got[(name, "1x2")] = [r[i] for r in two]
        got[(name, "2x2")] = [r[i] for r in four_dp]
        got[(name, "1x2x2")] = [r[i] for r in four_tp]
    for i, name in enumerate(extra, start=len(setup)):
        got[(name, "1x2")] = [r[i] for r in two]
    ckpt = {"ranks": [r[-2] for r in two], "path_in": path_in, "path_out": path_out,
            "cfg": ctc_cfg}
    return {"jax": steps, "one": one, "got": got, "ckpt": ckpt,
            "ops": [r[-1] for r in two]}


CASES = [(name, g) for g in GRIDS for name in ("ctc", "transducer")]


@pytest.mark.parametrize("case,grid", CASES)
def test_sp_step_matches_jax_mesh(cases, case, grid):
    """The port's step on a (data, seq[, model]) grid against JAX's on the
    same mesh: loss and gradient norm within LOSS_RTOL on every rank, the
    parameters within PARAM_TOL and the running statistics within STATS_TOL
    of JAX's; each rank's place on the grid is its device's on JAX's mesh
    (seq between data and model). On the data 1 x seq 2 x model 2 mesh JAX's
    loss is held to, but its gradient is not JAX's data-parallel one (its
    norm lies 15-18% from it, its parameters 2e-3: CHANGES.md, PR 16), so
    there the port's gradient, parameters and statistics are held to JAX's
    data-parallel step over the same four devices."""
    new_params, new_stats, metrics, shape = cases["jax"][(case, grid)]
    ranks = cases["got"][(case, grid)]
    sizes = tuple(shape.get(a, 1) for a in ("data", "seq", "model"))
    assert shape["seq"] == 2 and np.prod(sizes) == len(ranks)
    for r in ranks:
        assert (r["data_rank"], r["seq_rank"], r["model_rank"]) == \
            np.unravel_index(r["rank"], sizes)
        assert (r["seq_size"], r["model_size"]) == sizes[1:]
        np.testing.assert_allclose(r["loss"], metrics["loss"], rtol=LOSS_RTOL)
    if grid == "1x2x2":
        new_params, new_stats, metrics, _ = cases["jax"][(case, "dp")]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], metrics["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["grad_norm"], metrics["grad_norm"], rtol=LOSS_RTOL)
    want = params_from_jax(new_params)
    for name, p in ranks[0]["params"].items():
        torch.testing.assert_close(p, want[name], rtol=0, atol=PARAM_TOL, msg=name)
    want_stats = stats_of(from_jax({"params": new_params, "batch_stats": new_stats}))
    got_stats = stats_of(ranks[0]["buffers"])
    assert got_stats.keys() == want_stats.keys() and got_stats
    for name, want_ in want_stats.items():
        assert rel_err(got_stats[name], want_) <= STATS_TOL, name


@pytest.mark.parametrize("case,grid", CASES)
def test_sp_step_matches_the_one_process_step(cases, case, grid):
    """The same steps against the port's own one-process step over the
    global batch, within ONE_TOL (the gradient norm of four ranks within
    FOUR_RANK_NORM_TOL), the parameters and buffers bit for bit equal across
    the ranks; the seq groups gather, exchange halos and reduce-scatter, and
    DDP reduces over the data x seq group."""
    ranks = cases["got"][(case, grid)]
    assert_matches_one_process(ranks, cases["one"][case],
                               ONE_TOL if len(ranks) == 2 else FOUR_RANK_NORM_TOL)
    for r in ranks:
        calls = r["sp_calls"]
        assert calls["all_gather"] > 0 and calls["halo"] > 0 and calls["reduce_scatter"] > 0
        assert r["ddp"] and not r["warnings"]
        assert (r["tp_calls"]["all_reduce"] > 0) == (grid == "1x2x2")


@pytest.mark.parametrize("case", ["vn", "interctc", "remat"])
def test_other_steps_match_the_one_process_step(cases, case):
    """At data 1 x seq 2: the Transducer with dropout 0.1, SpecAugment and
    variational noise (the seq ranks share the dropout stream and draw
    each mask at the whole length, keeping their frames; the noise is drawn
    on the parameters), the InterCTC model (taps after blocks 0, 1 and 3, on
    each rank's frames, their probabilities gathered for the loss) and
    remat "full" (the recompute repeats the block's collectives): each the
    one-process step within ONE_TOL."""
    ranks = cases["got"][(case, "1x2")]
    assert_matches_one_process(ranks, cases["one"][case])
    assert all(r["sp_calls"]["halo"] > 0 for r in ranks)


def test_uncovered_length_warns_and_runs_replicated(cases):
    """A batch of 20480 samples (65 / 33 / 17 frames: no point divides by 2)
    warns that sequence parallelism is inactive, runs every point
    replicated (no collective of the seq group) and still gives the
    one-process step."""
    ranks = cases["got"][("uncovered", "1x2")]
    assert_matches_one_process(ranks, cases["one"]["uncovered"])
    for r in ranks:
        assert len(r["warnings"]) == 1 and "INACTIVE" in r["warnings"][0]
        assert r["sp_calls"] == {"all_gather": 0, "halo": 0, "reduce_scatter": 0,
                                 "all_reduce": 0}


def test_checkpoints_cross_between_seq_2_and_one_process(cases):
    """A one-process checkpoint loads at seq 2 on every rank; the checkpoint
    saved at seq 2 after a step loads in one process with the ranks'
    weights and Adam moments, and the ranks train on after saving."""
    ck = cases["ckpt"]
    saved_in = torch.load(ck["path_in"], weights_only=True)["model"]
    for r in ck["ranks"]:
        assert np.isfinite(r["next_loss"])
        assert r["loaded"].keys() == saved_in.keys()
        for name, want in saved_in.items():
            assert torch.equal(r["loaded"][name], want), name
    full = Trainer(ck["cfg"], device="cpu")
    full.load(ck["path_out"])
    assert full.step == ADAM_COUNT + 1
    for name, want in ck["ranks"][0]["after"].items():
        assert torch.equal(full.model.state_dict()[name], want), name
    opt = full.optimizer.state_dict()["state"]
    for idx, entries in ck["ranks"][0]["opt"]["state"].items():
        for k, v in entries.items():
            assert torch.equal(opt[idx][k], v), (idx, k)


@pytest.mark.parametrize("name", list(CONV_CASES))
def test_conv_halo_matches_the_whole_convolution(cases, name):
    """A depthwise conv (kernel 7) on each rank's frames through ``halo``:
    at stride 1 and 2 from an odd offset (rank 1 starts at frame 9; at
    stride 2 it computes the outputs at the global even frames, from frame
    10 on), at stride 2 from an even one, and with 2 frames a rank (the
    halo of 3 reaches past the neighbour: the whole tensor is gathered):
    the rank's outputs, its input frames' gradient and the weight and bias
    gradients summed over the ranks are the whole convolution's."""
    conv, x, dy = conv_case(*CONV_CASES[name])
    x = x.requires_grad_()
    y = conv(x)
    (y * dy).sum().backward()
    n = x.shape[-1] // 2
    starts = []
    for r, ops in enumerate(cases["ops"]):
        c = ops["conv"][name]
        total, start, length = c["span"]
        starts.append(start)
        assert total == y.shape[-1] and c["calls"]["halo"] == 2
        torch.testing.assert_close(c["y"], y.detach()[..., start:start + length], rtol=0,
                                   atol=ONE_TOL)
        torch.testing.assert_close(c["dx"], x.grad[..., r * n:(r + 1) * n], rtol=0,
                                   atol=ONE_TOL * 10)
        for k, p in conv.named_parameters():
            torch.testing.assert_close(c["grads"][k], p.grad, rtol=0, atol=ONE_TOL * 10, msg=k)
    stride = CONV_CASES[name][0]
    assert starts == [0, -(-n // stride)]


def test_gather_and_split_time(cases):
    """``gather_time`` gives the whole tensor on every rank and, the same
    loss on every rank, sums the replicated side's gradient over the seq
    group (2 x the rank's slice); ``split_time`` gives the rank's share and
    returns the gathered gradient over the seq size."""
    gen = torch.Generator().manual_seed(3)
    whole = torch.randn(2, 8, 5, generator=gen)
    dy = torch.randn(2, 8, 5, generator=gen)
    for r, ops in enumerate(cases["ops"]):
        g = ops["gather"]
        assert torch.equal(g["gathered"], whole)
        torch.testing.assert_close(g["dx_gather"], 2 * dy[:, 4 * r:4 * r + 4], rtol=0, atol=0)
        assert torch.equal(g["split"], whole[:, 4 * r:4 * r + 4])
        torch.testing.assert_close(g["dx_split"], dy / 2, rtol=0, atol=0)
        assert g["calls"] == {"all_gather": 2, "halo": 0, "reduce_scatter": 1, "all_reduce": 0}


def test_grouped_attention_straddling_the_ranks(cases):
    """A grouped (G = 3) rel-pos layer at 8 frames a rank: queries, keys and
    values gathered, each rank computing the groups that cover its frames
    (group 2, frames 6-8, on both) from its first group's position; its
    outputs, its input frames' gradient and the parameters' gradients
    summed over the ranks are the whole layer's."""
    layer, x, mask, dy = attention_case()
    x = x.requires_grad_()
    y = layer(x, mask)
    (y * dy).sum().backward()
    want = {n: p.grad for n, p in layer.named_parameters() if p.grad is not None}
    for r, ops in enumerate(cases["ops"]):
        a = ops["attention"]
        torch.testing.assert_close(a["y"], y.detach()[:, 8 * r:8 * r + 8], rtol=0, atol=ONE_TOL)
        torch.testing.assert_close(a["dx"], x.grad[:, 8 * r:8 * r + 8], rtol=0, atol=ONE_TOL)
        assert a["grads"].keys() == want.keys()
        for n, g in want.items():
            torch.testing.assert_close(a["grads"][n], g, rtol=0, atol=ONE_TOL * 10, msg=n)
        assert a["calls"] == {"all_gather": 1, "halo": 0, "reduce_scatter": 1, "all_reduce": 0}


def asr_configs() -> list:
    out = []
    for path in sorted(glob.glob("configs/*.json")):
        with open(path) as f:
            cfg = json.load(f)
        if "encoder_params" in cfg and cfg.get("model_type") != "LM":
            out.append(path)
    return out


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("path", asr_configs())
def test_planners_match_jax(path, sp):
    """``seq_frame_schedule``, ``sp_coverage``, ``sp_audio_lengths`` and
    ``sp_pad_align`` against the JAX package's on a shipped ASR config: the
    schedules and coverages at lengths around the loader's bucket edges,
    the aligned lengths over a window, and each bucket edge's alignment."""
    with open(path) as f:
        enc = json.load(f)["encoder_params"]
    edges = make_buckets(256000, 8)
    for t in list(edges) + [SP_SAMPLES, UNCOVERED, 16000, 160000 + 480]:
        assert mesh.seq_frame_schedule(enc, t) == mesh_lib.seq_frame_schedule(enc, t)
        assert mesh.sp_coverage(enc, sp, t) == mesh_lib.sp_coverage(enc, sp, t)
    assert mesh.sp_audio_lengths(enc, sp, 150000, 170000) == \
        mesh_lib.sp_audio_lengths(enc, sp, 150000, 170000)
    align, want = mesh.sp_pad_align(enc, sp), mesh_lib.sp_pad_align(enc, sp)
    assert [align(e) for e in edges] == [want(e) for e in edges]


def test_grid_sizes_that_do_not_divide_are_refused():
    """seq_parallel 2 over a world of 1, and model 2 x seq 2 over 2, raise
    the JAX package's message, as ``make_mesh`` does."""
    with mesh.process_group(0, 1, "cpu"):
        with pytest.raises(ValueError, match=r"model_parallel=1 x seq_parallel=2 does not "
                                             r"divide the 1 visible"):
            mesh.make_grid(1, 2)
    with pytest.raises(ValueError, match=r"model_parallel=2 x seq_parallel=2 does not divide "
                                         r"the 2 visible"):
        mesh.check_model_parallel(2, 2, 2)
    with pytest.raises(ValueError, match=r"model_parallel=2 x seq_parallel=2 does not divide "
                                         r"the 2 visible"):
        mesh_lib.make_mesh(jax.devices()[:2], model_parallel=2, seq_parallel=2)
