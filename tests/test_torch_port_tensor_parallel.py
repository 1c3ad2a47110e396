"""PyTorch port vs the JAX package: tensor parallelism, on the CPU.

The port's Megatron-style step (parallel/tensor.py: column- and
row-parallel layers over model groups of two gloo ranks spawned by
parallel/mesh.launch, the rel-pos kernel's plain version on each rank's
heads, the grouped G = 3 stage on the gather path) at data 1 x model 2 and
data 2 x model 2 against the JAX package's Trainer on
``make_mesh(jax.devices()[:2], model_parallel=2)`` and ``[:4]`` with its
parameters placed by ``shard_params``, from the same weights and the same
non-zero Adam state: the shrunk flagship of ``dryrun.TINY_ENCODER`` (CTC;
the grouped stage, an expand block and a strided block), a Transducer on
that encoder and a narrowed LM-Transformer over ragged sequences. Loss and
global gradient norm within LOSS_RTOL, the updated parameters (gathered
whole) within PARAM_TOL and BatchNorm's running statistics within STATS_TOL
of JAX's; and the same steps against the port's own one-process step within
ONE_TOL, the replicated parameters bit for bit equal across the ranks. Then
a variational-noise step with dropout on, an LM whose 3 heads do not split
over two ranks (the gather path, a zero head padding the split), the other
attention paths (strided, absolute, even G, causal) layer by layer, checkpoints
between model 2 and one process, ``param_placement`` against JAX's
``param_spec`` on every leaf, and GLU's aligned ``pw1`` split against a
naive one. Dropout 0 and SpecAugment off against JAX, since random masks
cannot match across frameworks. The ranks run in two launches
(tests/torch_tp_ranks.py, which imports nothing of JAX) while JAX compiles
its steps here.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from test_torch_port_lm import lm_config
from test_torch_port_parallel import ADAM_COUNT, asr_batch, dp_lm_batch
from test_torch_port_training import (LOSS_RTOL, PARAM_TOL, STATS_TOL, adam_moments, rel_err,
                                      train_config, with_adam_state)
from test_torch_port_transducer import VOCAB as T_VOCAB
from test_torch_port_transducer import train_config as t_train_config
from torch_tp_ranks import (ATTENTION_VARIANTS, attention_case, attention_ranks,
                            checkpoint_rank, launch_jobs, tp_step)

from efficientconformer_tpu.config import from_dict
from efficientconformer_tpu.parallel import mesh as mesh_lib
from efficientconformer_tpu.training.trainer import Trainer as JaxTrainer
from efficientconformer_tpu.training.trainer import TrainerState
from efficientconformer_tpu.utils import torch_compat as TC
from efficientconformer_torch import dryrun
from efficientconformer_torch.models import factory
from efficientconformer_torch.models.layers import glu
from efficientconformer_torch.models.modules import ConvolutionModule
from efficientconformer_torch.parallel import tensor
from efficientconformer_torch.training.trainer import Trainer
from efficientconformer_torch.utils.weights import from_jax, params_from_jax

ONE_TOL = 1e-6       # the tensor-parallel step vs the one-process step, fp32: loss and
                     # norm relative, parameters and statistics relative to max(|x|, 1)
MESHES = {"1x2": 2, "2x2": 4}   # data x model -> ranks


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(cfg: dict) -> dict:
    cfg["encoder_params"].update(dryrun.TINY_ENCODER)
    return cfg


def configs() -> dict:
    """(config, global batch) of each case."""
    return {"ctc": (tiny(train_config()), asr_batch(16)),
            "transducer": (tiny(t_train_config()), asr_batch(T_VOCAB, seed=1)),
            "lm": (lm_config(), dp_lm_batch())}


def jax_tp_step(cfg, params, stats, batch, devices):
    """JAX's step on a (data, model 2) mesh of ``devices`` CPU devices, the
    parameters placed by ``shard_params`` and the batch sharded over the
    data axis, from ``params`` and the Adam state of ``adam_moments``."""
    mesh = mesh_lib.make_mesh(jax.devices()[:devices], model_parallel=2)
    jt = JaxTrainer(from_dict(cfg), mesh=mesh)
    jparams = jax.tree.map(jnp.asarray, params)
    mu, nu = adam_moments(params)
    state = TrainerState(params=mesh_lib.shard_params(mesh, jparams),
                         batch_stats=jax.tree.map(jnp.asarray, stats),
                         opt_state=with_adam_state(jt.tx.init(jparams), mu, nu, ADAM_COUNT),
                         step=jnp.asarray(ADAM_COUNT, jnp.int32))
    sharded = mesh_lib.shard_batch(mesh, batch, batch_axis=1)
    new, metrics = jt.train_step_fn()(state, sharded, jax.random.PRNGKey(0))
    return (jax.tree.map(np.asarray, new.params), jax.tree.map(np.asarray, new.batch_stats),
            {k: float(v) for k, v in metrics.items()})


def jax_params(name, cfg, batch):
    """(JAX params, batch_stats) of a case: the port's seeded draw converted,
    or, for the LM-Transformer (no converter that way), JAX's own init."""
    if name == "lm":
        state = JaxTrainer(from_dict(cfg)).init_state(
            jax.tree.map(lambda x: jnp.asarray(x[0]), batch))
        return jax.tree.map(np.asarray, state.params), {}
    port = Trainer(cfg, device="cpu", seed=0)
    convert = TC.convert_ctc if name == "ctc" else TC.convert_transducer
    return tuple(jax.tree.map(np.array, t) for t in convert(port.model.state_dict()))


def vn_config() -> dict:
    """The Transducer case with variational noise from step 0 and dropout
    0.1: at one data rank the tensor-parallel step draws what one process
    draws."""
    cfg = tiny(t_train_config())
    cfg["encoder_params"].update(Pdrop=0.1)
    cfg["training_params"].update(vn_start_step=0, vn_std=0.075)
    return cfg


def port_adam(cfg) -> tuple:
    """A seeded non-zero Adam state (moments by parameter name, count) for
    ``cfg``'s model, as ``adam_moments`` draws one for JAX's trees."""
    model, _ = factory.create_model(cfg, "cpu", torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    mu = {n: (rng.standard_normal(s) * 1e-3).astype(np.float32) for n, s in shapes}
    nu = {n: rng.uniform(1e-4, 1e-3, s).astype(np.float32) for n, s in shapes}
    return mu, nu, ADAM_COUNT


def uneven_lm_config() -> dict:
    """The LM with 3 heads of 16: a rank's 24 columns are 1.5 heads."""
    cfg = lm_config()
    cfg["lm_params"].update(dim_model=48, num_heads=3)
    return cfg


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Every case's JAX steps, the port's one-process steps, and the ranks'
    results: a launch of two ranks and one of four run in a thread while
    JAX compiles here."""
    tmp = tmp_path_factory.mktemp("tp")
    port_weights, adams, one = {}, {}, {}
    setup = {}
    for name, (cfg, batch) in configs().items():
        params, stats = jax_params(name, cfg, batch)
        weights = from_jax({"params": params}) if name == "lm" else None
        mu, nu = (params_from_jax(t) for t in adam_moments(params))
        adams[name], port_weights[name] = (mu, nu, ADAM_COUNT), weights
        setup[name] = (cfg, batch, params, stats)
        one[name] = dryrun.shard_step(cfg, batch, 0, adams[name], None, 1, "cpu", weights,
                                      grads=True)
    extra = {"vn": (vn_config(), asr_batch(T_VOCAB, seed=2)),
             "uneven": (uneven_lm_config(), dp_lm_batch())}
    for name, (cfg, batch) in extra.items():
        adams[name] = port_adam(cfg)
        one[name] = dryrun.shard_step(cfg, batch, 0, adams[name], None, 1, "cpu", grads=True)
    ctc_cfg, ctc_batch = setup["ctc"][:2]
    path_in, path_out = str(tmp / "one.ckpt"), str(tmp / "tp.ckpt")
    Trainer(ctc_cfg, device="cpu", seed=7).save(path_in)

    jobs2 = [(tp_step, (cfg, batch, adams[n], port_weights[n])) for n, (cfg, batch, _, _)
             in setup.items()]
    jobs2 += [(tp_step, (cfg, batch, adams[n])) for n, (cfg, batch) in extra.items()]
    jobs2.append((checkpoint_rank, (ctc_cfg, ctc_batch, adams["ctc"], path_in, path_out)))
    jobs2.append((attention_ranks, (list(ATTENTION_VARIANTS),)))
    jobs4 = [(tp_step, (cfg, batch, adams[n], port_weights[n])) for n, (cfg, batch, _, _)
             in setup.items()]

    def ranks():
        return launch_jobs(jobs2, 2), launch_jobs(jobs4, 4)

    with ThreadPoolExecutor(1 + len(setup) * len(MESHES)) as pool:
        launched = pool.submit(ranks)
        # XLA compiles the six steps side by side
        steps = {(name, m): pool.submit(jax_tp_step, cfg, params, stats, batch, devices)
                 for m, devices in MESHES.items()
                 for name, (cfg, batch, params, stats) in setup.items()}
        steps = {k: f.result() for k, f in steps.items()}
        two, four = launched.result()
    got = {}
    for i, name in enumerate(setup):
        got[(name, "1x2")] = [r[i] for r in two]
        got[(name, "2x2")] = [r[i] for r in four]
    for i, name in enumerate(extra, start=len(setup)):
        got[(name, "1x2")] = [r[i] for r in two]
    ckpt = {"ranks": [r[-2] for r in two], "path_in": path_in, "path_out": path_out,
            "cfg": ctc_cfg}
    attention = {name: [r[-1][i] for r in two] for i, name in enumerate(ATTENTION_VARIANTS)}
    return {"jax": steps, "one": one, "got": got, "ckpt": ckpt, "attention": attention}


def stats_of(buffers: dict) -> dict:
    return {k: v for k, v in buffers.items() if "running" in k}


CASES = [(name, m) for m in MESHES for name in ("ctc", "transducer", "lm")]


@pytest.mark.parametrize("case,grid", CASES)
def test_tp_step_matches_jax_mesh(cases, case, grid):
    """The port's step at data x model against JAX's on the same (data,
    model) mesh: loss and gradient norm within LOSS_RTOL on every rank, the
    gathered parameters within PARAM_TOL and the running statistics within
    STATS_TOL of JAX's."""
    new_params, new_stats, metrics = cases["jax"][(case, grid)]
    ranks = cases["got"][(case, grid)]
    assert [r["model_size"] for r in ranks] == [2] * MESHES[grid]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], metrics["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["grad_norm"], metrics["grad_norm"], rtol=LOSS_RTOL)
    want = params_from_jax(new_params)
    for name, p in ranks[0]["params"].items():
        torch.testing.assert_close(p, want[name], rtol=0, atol=PARAM_TOL, msg=name)
    if case == "lm":
        return
    want_stats = stats_of(from_jax({"params": new_params, "batch_stats": new_stats}))
    got_stats = stats_of(ranks[0]["buffers"])
    assert got_stats.keys() == want_stats.keys() and got_stats
    for name, want_ in want_stats.items():
        assert rel_err(got_stats[name], want_) <= STATS_TOL, name


def assert_matches_one_process(ranks, one, norm_tol=ONE_TOL):
    """Every rank's step against the one-process step within ONE_TOL (the
    gradient norm within ``norm_tol``); the ranks' losses and norms equal,
    their replicated parameters and the gathered parameters and buffers bit
    for bit equal."""
    for r in ranks:
        assert abs(r["loss"] - one["loss"]) <= ONE_TOL * abs(one["loss"])
        assert abs(r["grad_norm"] - one["grad_norm"]) <= norm_tol * abs(one["grad_norm"])
        assert r["loss"] == ranks[0]["loss"] and r["grad_norm"] == ranks[0]["grad_norm"]
        assert r["replicated"].keys() <= one["params"].keys() and r["replicated"]
        for name, p in r["replicated"].items():
            assert torch.equal(p, ranks[0]["replicated"][name]), name
        for key in ("params", "buffers"):
            for name, p in r[key].items():
                assert torch.equal(p, ranks[0][key][name]), (key, name)
    for key in ("params", "buffers"):
        assert ranks[0][key].keys() == one[key].keys()
        for name, want in one[key].items():
            if want.is_floating_point():
                assert rel_err(ranks[0][key][name], want) <= ONE_TOL, (key, name)


@pytest.mark.parametrize("case,grid", CASES)
def test_tp_step_matches_the_one_process_step(cases, case, grid):
    """The same steps against the port's own one-process step over the
    global batch, within ONE_TOL; the model groups issue their all-reduces
    and all-gathers, and at two data ranks DDP its gradient buckets."""
    ranks = cases["got"][(case, grid)]
    assert_matches_one_process(ranks, cases["one"][case])
    for r in ranks:
        assert r["tp_calls"]["all_reduce"] > 0 and r["tp_calls"]["all_gather"] > 0
        assert r["ddp"] == (grid == "2x2")


def test_variational_noise_step_matches_the_one_process_step(cases):
    """The Transducer with variational noise and dropout 0.1 at data 1 x
    model 2: each sharded weight's noise is drawn at its full shape and cut,
    the inner dropout's mask drawn whole and sliced, so the step is the
    one-process step within ONE_TOL."""
    ranks = cases["got"][("vn", "1x2")]
    assert_matches_one_process(ranks, cases["one"]["vn"])


def test_heads_that_do_not_split_take_the_gather_path(cases):
    """An LM whose 3 heads do not split over two ranks: q, k and v gathered,
    a zero head padding each rank to 2 heads, the heads' outputs gathered;
    the step is the one-process step within ONE_TOL."""
    ranks = cases["got"][("uneven", "1x2")]
    assert_matches_one_process(ranks, cases["one"]["uneven"])


@pytest.mark.parametrize("variant", list(ATTENTION_VARIANTS))
def test_attention_variants_match_the_whole_layer(cases, variant):
    """The attention paths beside the main path's, on two ranks' shards:
    strided and absolute (plain and grouped) on the gather path, even G on
    the skewing path's gather, causal on the skewing path's whole heads;
    the output, the input's gradient and every parameter's gradient
    (gathered) those of the whole layer within ONE_TOL."""
    module, x, mask, dy = attention_case(variant)
    x = x.requires_grad_()
    y = module(x, mask)
    (y * dy).sum().backward()
    for r in cases["attention"][variant]:
        torch.testing.assert_close(r["y"], y.detach(), rtol=0, atol=ONE_TOL)
        torch.testing.assert_close(r["dx"], x.grad, rtol=0, atol=ONE_TOL)
        want = {n: p.grad for n, p in module.named_parameters() if p.grad is not None}
        assert r["grads"].keys() == want.keys()
        for n, g in want.items():
            torch.testing.assert_close(r["grads"][n], g, rtol=0, atol=ONE_TOL, msg=n)


def test_checkpoints_cross_between_model_2_and_one_process(cases):
    """A one-process checkpoint loads at model 2 (each rank its shards, the
    gathered weights the file's); the checkpoint saved at model 2 after a
    step holds the full layout and loads in one process, weights and Adam
    moments equal to the ranks' gathered ones; the ranks train on after
    saving."""
    ck = cases["ckpt"]
    saved_in = torch.load(ck["path_in"], weights_only=True)["model"]
    for r in ck["ranks"]:
        assert np.isfinite(r["next_loss"])
        assert r["loaded"].keys() == saved_in.keys()
        for name, want in saved_in.items():
            assert torch.equal(r["loaded"][name], want), name
    shapes = ck["ranks"][0]["shapes"]
    full = Trainer(ck["cfg"], device="cpu")
    assert any(tuple(p.shape) != shapes[n] for n, p in full.model.named_parameters())
    full.load(ck["path_out"])
    assert full.step == ADAM_COUNT + 1
    for name, want in ck["ranks"][0]["after"].items():
        assert torch.equal(full.model.state_dict()[name], want), name
    opt = full.optimizer.state_dict()["state"]
    for idx, entries in ck["ranks"][0]["opt"]["state"].items():
        for k, v in entries.items():
            assert torch.equal(opt[idx][k], v), (idx, k)


def leaf_names(params) -> dict:
    """The port's name of every JAX leaf: each leaf filled with its index,
    carried across by from_jax's layout map (transposes and reorders keep
    the values)."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
    marked = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(x), i + 1, np.float32) for i, (_, x) in enumerate(leaves)])
    port = params_from_jax(marked)
    names = {}
    for name, t in port.items():
        i = int(t.reshape(-1)[0]) - 1
        assert torch.all(t == i + 1), name
        names[tuple(str(getattr(k, "key", k)) for k in leaves[i][0])] = name
    return names, [(tuple(str(getattr(k, "key", k)) for k in path), x) for path, x in leaves]


# the placements the port takes where the JAX package replicates: the depthwise
# conv and BatchNorm of the convolution module act per channel, on the rank's
JAX_REPLICATED_PORT_BY_CHANNEL = ("dw", "bn")


@pytest.mark.parametrize("case", ["ctc", "transducer", "lm"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_param_placement_agrees_with_jax_param_spec(case, n):
    """``param_placement`` against JAX's ``param_spec`` on a (data, model n)
    mesh, leaf by leaf: a column-parallel kernel (P(None, "model")) or bias
    (P("model")) is "column" (the torch weight's rows), a row-parallel
    kernel (P("model", None)) "row" (its columns), P() "replicated", widths
    n does not divide included (the fallback at n 3); the one departure,
    listed: the convolution module's dw and bn, replicated in JAX, go by
    channel where the channels split."""
    cfg, batch = configs()[case]
    params, _ = jax_params(case, cfg, batch)
    names, leaves = leaf_names(params)
    model, _ = factory.create_model(cfg, "cpu", torch.Generator().manual_seed(0))
    placement = tensor.param_placement(model, n)
    mesh = mesh_lib.make_mesh(jax.devices()[:{2: 2, 3: 6, 4: 4}[n]], model_parallel=n)
    kinds = {}
    for path, leaf in leaves:
        spec = mesh_lib.param_spec(path, leaf, mesh)
        pl = placement[names[path]]
        if spec == P(None, "model") or spec == P("model") and path[-1] == "bias":
            assert pl.kind == "column" and pl.dim == 0, (path, pl)
        elif spec == P("model", None) or spec == P("model"):
            assert pl.kind == "row" and pl.dim == 1, (path, pl)
        elif path[-2] in JAX_REPLICATED_PORT_BY_CHANNEL and pl.kind != "replicated":
            assert pl.kind == "channel" and np.shape(leaf)[-1] % n == 0, (path, pl)
        else:
            assert spec == P() and pl.kind == "replicated", (path, spec, pl)
        kinds[pl.kind] = kinds.get(pl.kind, 0) + 1
        assert pl.glu == (path[-2] == "pw1" and pl.kind == "column"), path
    assert kinds.get("replicated")
    if n != 3:    # at 3 every width of the LM and most of the encoders' stay whole
        assert kinds.get("column") and kinds.get("row")
        assert bool(kinds.get("channel")) == (case != "lm")


def test_glu_aligned_pw1_split_against_a_naive_split():
    """pw1 (D -> 2E) split for GLU: rank r's value channels [rE/n, (r+1)E/n)
    with the same gate channels E + [rE/n, (r+1)E/n), so GLU on the rank's
    channels is the rank's slice of the whole GLU; a contiguous split of
    the 2E channels (rank 0 the values, rank 1 the gates) is not."""
    gen = torch.Generator().manual_seed(0)
    conv = ConvolutionModule(8, 6, 3, 0.0)
    pw1 = conv.layers[2]
    with torch.no_grad():
        pw1.weight.normal_(generator=gen)
        pw1.bias.normal_(generator=gen)
    x = torch.randn(2, 8, 5, generator=gen)
    whole = glu(pw1(x), dim=1)
    name = "encoder.blocks.0.convolution_module.layers.2.weight"
    pl = tensor.placement_of(name, tuple(pw1.weight.shape), 2)
    assert pl.kind == "column" and pl.glu
    naive = pl._replace(glu=False)
    for r in range(2):
        def part(p):
            return torch.nn.functional.conv1d(x, tensor.shard_tensor(pw1.weight, p, r, 2),
                                              tensor.shard_tensor(pw1.bias, p, r, 2))
        torch.testing.assert_close(glu(part(pl), dim=1), whole[:, 3 * r:3 * r + 3],
                                   rtol=0, atol=1e-6)
        assert not torch.allclose(glu(part(naive), dim=1), whole[:, 3 * r:3 * r + 3],
                                  atol=1e-2)
    parts = [tensor.shard_tensor(pw1.weight, pl, r, 2) for r in range(2)]
    assert torch.equal(tensor.unshard_tensor(parts, pl), pw1.weight)


def test_shard_state_dict_round_trip():
    """Every parameter and buffer of the shrunk flagship cut to two ranks'
    shards and put back is the full state dict; the sharded layers' shapes
    halve where the JAX rule shards them."""
    cfg = configs()["ctc"][0]
    model, _ = factory.create_model(cfg, "cpu", torch.Generator().manual_seed(0))
    full = model.state_dict()
    parts = [tensor.shard_state_dict(full, r, 2) for r in range(2)]
    placement = tensor.param_placement(model, 2)
    halved = 0
    for name, t in full.items():
        pl = placement[name]
        got = tensor.unshard_tensor([p[name] for p in parts], pl)
        assert torch.equal(got, t), name
        if pl.kind != "replicated":
            halved += 1
            assert parts[0][name].numel() * 2 == t.numel(), name
    assert halved > 0


def test_model_parallel_that_does_not_divide_the_ranks_is_refused():
    """model_parallel 3 over a world of 2 raises the JAX package's message,
    as ``make_mesh`` does for 3 over 2 devices."""
    from efficientconformer_torch.parallel import mesh

    with mesh.process_group(0, 1, "cpu"):
        with pytest.raises(ValueError, match="does not divide the 1 visible"):
            mesh.make_grid(3)
    with pytest.raises(ValueError, match="does not divide the 2 visible"):
        mesh_lib.make_mesh(jax.devices()[:2], model_parallel=3)
