"""PyTorch port vs the JAX package: tensor parallelism's remainder, on the CPU.

The layers whose width the model size does not divide run replicated, as
the JAX package's GSPMD runs them: a data 1 x model 3 step of the shrunk
flagship at three blocks (its stage-1 and stage-3 widths 16 and 32, their
FFNs and the 16-word vocabulary replicated; stage 2's 24 columns split, its
2 heads of 12 on the gather path) and of a Transducer on its first two
blocks (the joint's 12-wide frame and state projections split, its 16-word
vocabulary projection replicated), and data 1 x model 2 steps of two
blocks through local and linear attention (1 head a rank), each a step of
one microbatch of 4 rows against
JAX's step on ``make_mesh(jax.devices()[:n], model_parallel=n)`` from the same weights and Adam state (LOSS_RTOL,
PARAM_TOL, STATS_TOL), and against the port's one-process step (ONE_TOL;
the gradient norm RANKS_NORM_TOL), the replicated tensors counted against
``placement_of`` and bit for bit equal across the ranks. Then a causal
rel-pos layer's growing KV cache, its fixed-capacity one-token step and the
causal convolution module's streaming step at model 2, on whole heads (4
heads of 6) and on the gather path (3 heads of 8), against the whole
layer's and against the JAX modules' cached step and causal forward; every
shipped config at tiny depth through ``shard_model_`` at model 3; and the
unsharded gradient norm against float64. The ranks run in two launches
(tests/torch_tp_ranks.py) while JAX compiles its four mesh steps here.
"""

import glob
import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from test_torch_port_parallel import ADAM_COUNT, asr_batch
from test_torch_port_tensor_parallel import (ONE_TOL, assert_matches_one_process, jax_params,
                                             stats_of, tiny)
from test_torch_port_training import (LOSS_RTOL, PARAM_TOL, STATS_TOL, adam_moments, rel_err,
                                      train_config, with_adam_state)
from test_torch_port_transducer import VOCAB as T_VOCAB
from test_torch_port_transducer import train_config as t_train_config
from test_torch_port_variants import TOL, jit_init, mhsa_state, perturbed
from torch_tp_ranks import (CACHE_FRAMES, CACHE_HEADS, CACHE_SLOTS, CONV_KERNEL, cache_layers,
                            cached_ranks, launch_jobs, run_cached, tp_step)

from efficientconformer_tpu.config import from_dict
from efficientconformer_tpu.models.attentions import MultiHeadSelfAttention as JaxMHSA
from efficientconformer_tpu.models.modules import ConvolutionModule as JaxConvolutionModule
from efficientconformer_tpu.parallel import mesh as mesh_lib
from efficientconformer_tpu.training.trainer import Trainer as JaxTrainer
from efficientconformer_tpu.training.trainer import TrainerState
from efficientconformer_torch import dryrun
from efficientconformer_torch.models import factory
from efficientconformer_torch.models.attentions import MultiHeadSelfAttention
from efficientconformer_torch.models.layers import Conv1d, Linear
from efficientconformer_torch.models.modules import ConvolutionModule, FeedForwardModule
from efficientconformer_torch.parallel import tensor
from efficientconformer_torch.utils import weights as W
from efficientconformer_torch.utils.weights import params_from_jax

# the gradient norm of a step split over ranks against the one-process step:
# the sums over time, over the ranks' partial products and over the batch
# run in another order. On these batches the already-split paths read this
# far too: the flagship's own seq-2 step 1.04e-6 (its gradients 3.6e-6 from
# one process in norm, most of it the input projection's sum over time)
RANKS_NORM_TOL = 3e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def shallow(cfg: dict, blocks: int) -> dict:
    """``tiny``'s encoder cut to ``blocks`` blocks (3: widths 16 / 24 / 32,
    blocks 1 and 2 strided and expanding; 2: widths 16 / 24), so that JAX
    compiles its mesh step in seconds."""
    cfg = tiny(cfg)
    edge = list(range(1, blocks))[:2]
    cfg["encoder_params"].update(num_blocks=blocks, expand_blocks=edge, strided_blocks=edge,
                                 dim_model=[16, 24, 32][:len(edge) + 1],
                                 att_group_size=[3, 1, 1][:len(edge) + 1])
    return cfg


def local_config() -> dict:
    cfg = shallow(train_config(), 2)
    cfg["encoder_params"].update(att_group_size=1, att_kernel_size=3)
    return cfg


def linear_config() -> dict:
    cfg = shallow(train_config(), 2)
    cfg["encoder_params"].update(linear_att=True, relative_pos_enc=False)
    return cfg


def one_microbatch(cfg: dict, batch: dict) -> tuple:
    """(config, batch) of one microbatch a step: JAX unrolls the
    accumulation, so each microbatch adds its compile."""
    cfg["training_params"]["accumulated_steps"] = 1
    return cfg, {k: v[:1] for k, v in batch.items()}


def steps() -> dict:
    """name: (config, global batch, model size, JAX converter name)."""
    return {"ctc-model3": (*one_microbatch(shallow(train_config(), 3), asr_batch(16)), 3,
                           "ctc"),
            "transducer-model3": (*one_microbatch(shallow(t_train_config(), 2),
                                                  asr_batch(T_VOCAB, seed=1)), 3, "transducer"),
            "local-model2": (*one_microbatch(local_config(), asr_batch(16, seed=2)), 2, "ctc"),
            "linear-model2": (*one_microbatch(linear_config(), asr_batch(16, seed=3)), 2, "ctc")}


def jax_mesh_step(cfg, params, stats, batch, model):
    """JAX's step on a (data 1, model ``model``) mesh, the parameters placed
    by ``shard_params``, from ``params`` and the Adam state of
    ``adam_moments``."""
    mesh = mesh_lib.make_mesh(jax.devices()[:model], model_parallel=model)
    jt = JaxTrainer(from_dict(cfg), mesh=mesh)
    jparams = jax.tree.map(jnp.asarray, params)
    mu, nu = adam_moments(params)
    state = TrainerState(params=mesh_lib.shard_params(mesh, jparams),
                         batch_stats=jax.tree.map(jnp.asarray, stats),
                         opt_state=with_adam_state(jt.tx.init(jparams), mu, nu, ADAM_COUNT),
                         step=jnp.asarray(ADAM_COUNT, jnp.int32))
    new, metrics = jt.train_step_fn()(state, mesh_lib.shard_batch(mesh, batch, batch_axis=1),
                                      jax.random.PRNGKey(0))
    return (jax.tree.map(np.asarray, new.params), jax.tree.map(np.asarray, new.batch_stats),
            {k: float(v) for k, v in metrics.items()})


def cache_inputs():
    """The JAX modules of the cached cases, their variables (the BatchNorm
    statistics moved off their init), the port's whole-layer states and the
    input (B 2, CACHE_FRAMES, D 24)."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((2, CACHE_FRAMES, 24)) * 0.5).astype(np.float32)
    jconv = JaxConvolutionModule(dim_model=24, dim_expand=24, kernel_size=CONV_KERNEL,
                                 dropout=0.0, causal=True)
    conv_vars = perturbed(jit_init(jconv, 5, x, train=False), 6)
    conv_sd = {}
    p, st = conv_vars["params"], conv_vars["batch_stats"]
    W._norm(conv_sd, "convolution_module.layers.0", p["ln"])
    W._pointwise(conv_sd, "convolution_module.layers.2", p["pw1"])
    W._conv1d(conv_sd, "convolution_module.layers.4", p["dw"])
    W._batch_norm(conv_sd, "convolution_module.layers.5", p["bn"], st["bn"])
    W._pointwise(conv_sd, "convolution_module.layers.7", p["pw2"])
    conv_sd = {k: torch.as_tensor(np.array(v)) for k, v in conv_sd.items()}
    jmods, jvars, states = {}, {}, {}
    for i, (name, heads) in enumerate(CACHE_HEADS.items()):
        jmods[name] = JaxMHSA(dim_model=24, num_heads=heads, relative_pos_enc=True, causal=True,
                              fused=False)
        jvars[name] = jit_init(jmods[name], 7 + i, x[:, :4])
        states[name] = {**{f"mhsa.{k}": v for k, v in mhsa_state(jvars[name]["params"]).items()},
                        **conv_sd}
    return (jconv, conv_vars), jmods, jvars, states, x


def jax_cached(jmod, variables, x):
    """The JAX layer's growing cache over the chunks of ``run_cached`` and
    its fixed-capacity step token by token."""
    o1, hidden = jmod.apply(variables, jnp.asarray(x[:, :4]), None, None)
    o2, _ = jmod.apply(variables, jnp.asarray(x[:, 4:]), None, hidden)
    step = jax.jit(lambda v, xt, h: jmod.apply(v, xt, None, h))
    b = x.shape[0]
    hidden = {"k": jnp.zeros((b, CACHE_SLOTS, 24)), "v": jnp.zeros((b, CACHE_SLOTS, 24)),
              "pos": jnp.zeros((b,), jnp.int32)}
    outs = []
    for t in range(x.shape[1]):
        o, hidden = step(variables, jnp.asarray(x[:, t:t + 1]), hidden)
        outs.append(np.asarray(o))
    return np.concatenate([np.asarray(o1), np.asarray(o2)], 1), np.concatenate(outs, 1)


@pytest.fixture(scope="module")
def cases():
    """JAX's four mesh steps, the port's one-process steps and the ranks'
    results: a launch of three ranks and one of two run in threads while
    JAX compiles here."""
    setup, adams, one = {}, {}, {}
    for name, (cfg, batch, n, kind) in steps().items():
        params, stats = jax_params(kind, cfg, batch)
        mu, nu = (params_from_jax(t) for t in adam_moments(params))
        adams[name] = (mu, nu, ADAM_COUNT)
        setup[name] = (cfg, batch, n, params, stats)
    conv, jmods, jvars, states, x = cache_inputs()
    jobs = {n: [(tp_step, (cfg, batch, adams[name], None, n))
                for name, (cfg, batch, m, _, _) in setup.items() if m == n] for n in (3, 2)}
    jobs[2].append((cached_ranks, (states, torch.from_numpy(x))))

    jconv, conv_vars = conv
    with ThreadPoolExecutor(3 + len(setup)) as pool:
        launched = {n: pool.submit(launch_jobs, jobs[n], n) for n in (3, 2)}
        futures = {name: pool.submit(jax_mesh_step, cfg, params, stats, batch, n)
                   for name, (cfg, batch, n, params, stats) in setup.items()}
        cached_jax = pool.submit(lambda: ({name: jax_cached(jmods[name], jvars[name], x)
                                           for name in CACHE_HEADS},
                                          np.asarray(jconv.apply(conv_vars, jnp.asarray(x),
                                                                 train=False))))
        for name, (cfg, batch, _, _, _) in setup.items():
            one[name] = dryrun.shard_step(cfg, batch, 0, adams[name], None, 1, "cpu",
                                          grads=True)
        jax_steps = {k: f.result() for k, f in futures.items()}
        outs = {n: f.result() for n, f in launched.items()}
    got = {}
    for n in (3, 2):
        names = [name for name, s in setup.items() if s[2] == n]
        for i, name in enumerate(names):
            got[name] = [r[i] for r in outs[n]]
        jax_cache, jax_conv = cached_jax.result()
    cached = [r[-1] for r in outs[2]]
    want = {name: (run_cached(cache_layers(CACHE_HEADS[name], states[name]),
                              torch.from_numpy(x)), jax_cache[name]) for name in CACHE_HEADS}
    return {"jax": jax_steps, "one": one, "got": got, "setup": setup, "cached": cached,
            "want": want, "jax_conv": jax_conv}


STEPS = list(steps())


@pytest.mark.parametrize("case", STEPS)
def test_step_matches_jax_mesh(cases, case):
    """The port's step at data 1 x model n against JAX's on the same mesh:
    loss and gradient norm within LOSS_RTOL on every rank, the gathered
    parameters within PARAM_TOL and the running statistics within STATS_TOL
    of JAX's."""
    new_params, new_stats, metrics = cases["jax"][case]
    ranks = cases["got"][case]
    n = cases["setup"][case][2]
    assert [r["model_size"] for r in ranks] == [n] * n
    for r in ranks:
        np.testing.assert_allclose(r["loss"], metrics["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["grad_norm"], metrics["grad_norm"], rtol=LOSS_RTOL)
    want = params_from_jax(new_params)
    for name, p in ranks[0]["params"].items():
        torch.testing.assert_close(p, want[name], rtol=0, atol=PARAM_TOL, msg=name)
    want_stats = stats_of(W.from_jax({"params": new_params, "batch_stats": new_stats}))
    got_stats = stats_of(ranks[0]["buffers"])
    assert got_stats.keys() == want_stats.keys() and got_stats
    for name, want_ in want_stats.items():
        assert rel_err(got_stats[name], want_) <= STATS_TOL, name


@pytest.mark.parametrize("case", STEPS)
def test_step_matches_the_one_process_step(cases, case):
    """The same steps against the port's one-process step within ONE_TOL
    (the norm within RANKS_NORM_TOL), the replicated parameters bit for bit
    equal across the ranks: every tensor ``placement_of`` replicates, the
    layers whose width n does not divide among them, and the model group's
    all-reduces and all-gathers issued."""
    cfg, _, n, _, _ = cases["setup"][case]
    ranks = cases["got"][case]
    assert_matches_one_process(ranks, cases["one"][case], RANKS_NORM_TOL)
    model, _ = factory.create_model(cfg, "cpu", torch.Generator().manual_seed(0))
    placement = tensor.param_placement(model, n)
    replicated = {k for k, p in model.named_parameters() if placement[k].kind == "replicated"}
    split = {k for k, p in placement.items() if p.kind != "replicated"}
    assert ranks[0]["replicated"].keys() == replicated and split
    if n == 3:   # widths 3 does not divide, run replicated
        assert any(".layers.1.weight" in k and "feed_forward" in k for k in replicated)
        assert "fc.weight" in replicated or "joint_network.linear_joint.weight" in replicated
    for r in ranks:
        assert r["tp_calls"]["all_reduce"] > 0 and r["tp_calls"]["all_gather"] > 0


@pytest.mark.parametrize("kind", ["cached", "step", "conv"])
@pytest.mark.parametrize("heads", list(CACHE_HEADS))
def test_cached_attention_and_conv_step_at_model_2(cases, heads, kind):
    """A causal rel-pos layer's growing cache (two chunks), its
    fixed-capacity step token by token and the causal convolution module's
    streaming step, on two ranks' shards: whole heads (the cache and the
    conv state hold the rank's columns and channels) or the gather path (3
    heads of 8: the cache holds the whole width). Each rank's output is the
    whole layer's within ONE_TOL, and the whole layer's the JAX modules'
    (the cached apply, the fixed-cache apply, the causal convolution over
    the sequence) within TOL."""
    whole, (jax_cached_out, jax_step_out) = cases["want"][heads]
    want_jax = {"cached": jax_cached_out, "step": jax_step_out, "conv": cases["jax_conv"]}[kind]
    np.testing.assert_allclose(whole[kind].numpy(), want_jax, rtol=0, atol=TOL)
    width = 12 if heads == "whole-heads" else 24
    for r in cases["cached"]:
        got = r[heads]
        torch.testing.assert_close(got[kind], whole[kind], rtol=0, atol=ONE_TOL)
        assert (got["hidden_width"], got["cache_width"], got["state_width"]) == (width, width, 12)


def tiny_depth(cfg: dict) -> dict:
    """A shipped config at one block a stage (its widths, heads and
    vocabulary as shipped), an LM at one block."""
    cfg = json.loads(json.dumps(cfg))
    if "encoder_params" in cfg:
        p = cfg["encoder_params"]
        stages = len(p.get("expand_blocks", []))
        strided = p.get("strided_blocks", []) == p.get("expand_blocks", [])
        p.update(num_blocks=stages + 1, expand_blocks=list(range(stages)),
                 strided_blocks=list(range(stages)) if strided and stages else [])
    else:
        cfg["lm_params"].update({k: 1 for k in ("num_blocks", "num_layers")
                                 if k in cfg["lm_params"]})
    return cfg


SHIPPED = sorted(glob.glob("configs/*.json"))


@pytest.mark.parametrize("path", SHIPPED)
def test_shipped_configs_shard_at_model_3(path):
    """Every shipped config at tiny depth takes ``shard_model_`` at model 3
    (rank 1 of 3), refusing nothing: each layer's parallel form follows its
    placement (sharded where ``placement_of`` splits it, whole where it
    replicates), and the replicated tensors are those ``placement_of``
    replicates."""
    with open(path) as f:
        cfg = tiny_depth(json.load(f))
    model, _ = factory.create_model(cfg, "cpu", torch.Generator().manual_seed(0))
    placement = tensor.param_placement(model, 3)
    tensor.shard_model_(model, tensor.Region(None, 1, 3))
    first = {FeedForwardModule: "layers.1", ConvolutionModule: "layers.2",
             MultiHeadSelfAttention: "query_layer"}
    forms = 0
    for name, m in model.named_modules():
        if type(m) in first:
            split = placement[f"{name}.{first[type(m)]}.weight"].kind != "replicated"
            assert (m.tp is not None) == split, name
        if isinstance(m, (Linear, Conv1d)) and placement.get(f"{name}.weight") is not None \
                and placement[f"{name}.weight"].kind != "channel":
            assert (m.tp_mode is not None) == (placement[f"{name}.weight"].kind != "replicated"), \
                name
            forms += m.tp_mode is not None
    for name, p in model.named_parameters():
        assert (getattr(p, "tp_shard", None) is None) == (placement[name].kind == "replicated")
    assert any(pl.kind == "replicated" for pl in placement.values())


def test_grad_norm_unsharded_is_the_float64_norm():
    """``tensor.grad_norm`` of a whole model sums its gradients' squares in
    float64: a 360 x 14,400 gradient (the causal 4-head Large's input
    projection's shape) against its float64 norm within 1e-6 relative. An
    fp32 sum of its 5.2M squares (``torch.nn.utils.get_total_norm``) reads
    1.3e-4 low on it on the CPU."""
    model = nn.Linear(14400, 360)
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal((360, 14400)).astype(np.float32))
    gb = torch.from_numpy(rng.standard_normal(360).astype(np.float32))
    want = torch.sqrt(g.double().square().sum() + gb.double().square().sum()).item()
    got = tensor.grad_norm(model, [g, gb]).item()
    assert abs(got - want) <= 1e-6 * want
    assert tensor.grad_norm(model, [g, gb]).dtype == torch.float32
