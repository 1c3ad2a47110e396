"""PyTorch port vs the JAX package: sequence parallelism's remainder, on the CPU.

Every layer the JAX package's seq mesh runs computes on the rank's frames:
the skewing path (causal, even G, a full (T, T) mask) and the strided and
absolute paths on the bias attention's plain version at the rank's rows
against the gathered keys, local attention through a halo of K - 1 frames,
linear attention through the seq group's sums, the absolute encoding's
rows, and the Conv1d, Conv2dPool and VGG subsamplings from their windows of
the whole mel (VGG's second conv through a halo). Three tiny encoders carry
them against JAX's step on ``make_mesh(jax.devices()[:2], seq_parallel=2)``
from the same weights and Adam state (LOSS_RTOL, PARAM_TOL, STATS_TOL):
"causal" (rel-pos, left context 4, so that the padded rows see no key,
the Conv1d subsampling; a causal block, a strided attention block, an
even-G block, a local block), "absolute" (a limited
context's (T, T) mask, the Conv2dPool subsampling; a strided and an odd-G
absolute block) and "linear" (the VGG subsampling, on rows of the full
length: on padded rows the port's one-process step already lies 1.5e-3 from
JAX's in VGG's conv gradients, past PARAM_TOL, the padded frames' constant
mel making ties in its max-pools). Then each layer alone in
the shrunk flagship at data 1 x seq 2 against the port's one-process step
(ONE_TOL; the norm RANKS_NORM_TOL, as tests/test_torch_port_tp_remainder.py
says), the seq group's exchanges counted; the row-offset skew against the
whole skews; every shipped ASR config through ``shard_encoder_``. Dropout 0
and SpecAugment off. The ranks run in one launch (tests/torch_sp_ranks.py)
while JAX compiles its three mesh steps here.
"""

import glob
import json
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from test_torch_port_parallel import ADAM_COUNT
from test_torch_port_seq_parallel import jax_sp_step, sp_batch
from test_torch_port_tensor_parallel import assert_matches_one_process, port_adam, stats_of
from test_torch_port_tp_remainder import RANKS_NORM_TOL
from test_torch_port_training import (LOSS_RTOL, PARAM_TOL, STATS_TOL, adam_moments, rel_err,
                                      train_config)
from test_torch_port_variants import jit_init, perturbed
from torch_sp_ranks import SP_SAMPLES, launch_jobs, sp_step

from efficientconformer_tpu.config import from_dict
from efficientconformer_tpu.training.trainer import Trainer as JaxTrainer
from efficientconformer_torch import dryrun
from efficientconformer_torch.models.encoders import ConformerEncoder
from efficientconformer_torch.ops import attention as A
from efficientconformer_torch.parallel import mesh, sequence
from efficientconformer_torch.parallel.tensor import Region
from efficientconformer_torch.utils.weights import from_jax, params_from_jax

# (encoder keys over the flagship's shrunk encoder; its blocks 1 and 2 strided
# and expanding, widths 16 / 24 / 32)
MESH_CONFIGS = {
    "causal": dict(num_blocks=4, causal=True, left_context=4, subsampling_module="Conv1d",
                   att_stride=[2, 1], conv_stride=[1, 2], att_group_size=[1, 2, 1],
                   att_kernel_size=[None, 3], strided_layers=[3]),
    "absolute": dict(num_blocks=3, relative_pos_enc=False, left_context=5, right_context=2,
                     subsampling_module="Conv2dPool", att_stride=[2, 1], conv_stride=[1, 2],
                     att_group_size=[1, 3, 1]),
    "linear": dict(num_blocks=2, relative_pos_enc=False, linear_att=True,
                   subsampling_module="VGG", dim_model=[16, 24], strided_blocks=[1],
                   expand_blocks=[1]),
}
# each layer the seq mesh newly takes, alone in the shrunk flagship
LAYERS = {
    "Conv1d": {"subsampling_module": "Conv1d"},
    "VGG": {"subsampling_module": "VGG"},
    "Conv2dPool": {"subsampling_module": "Conv2dPool"},
    "absolute": {"relative_pos_enc": False},
    "linear": {"linear_att": True, "relative_pos_enc": False},
    "local": {"att_group_size": 1, "att_kernel_size": 3},
    "strided": {"att_stride": 2, "conv_stride": 1, "att_group_size": 1},
    "causal": {"causal": True, "left_context": 4},
    "even-G": {"att_group_size": [2, 1, 1]},
    "full-mask": {"left_context": 5, "right_context": 2},
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mesh_config(name: str) -> dict:
    """A mesh case's config, one microbatch a step (JAX unrolls the
    accumulation, so each microbatch adds its compile)."""
    cfg = train_config(accumulated_steps=1)
    cfg["encoder_params"].update(dryrun.TINY_ENCODER, strided_blocks=[1, 2],
                                 expand_blocks=[1, 2])
    cfg["encoder_params"].update(MESH_CONFIGS[name])
    return cfg


def layer_config(name: str) -> dict:
    cfg = dryrun.tiny_config()
    cfg["encoder_params"].update(LAYERS[name])
    return cfg


def aligned(cfg, seed, ragged=True):
    """An ``sp_batch`` of the config's vocabulary, its length aligned by
    ``sp_pad_align`` (every point of the encoder divides by 2); without
    ``ragged`` every row of that full length."""
    samples = mesh.sp_pad_align(cfg["encoder_params"], 2)(SP_SAMPLES)
    batch = sp_batch(cfg["tokenizer_params"]["vocab_size"], seed=seed, samples=samples)
    if not ragged:
        rng = np.random.default_rng(seed)
        batch["audio"] = (rng.standard_normal(batch["audio"].shape) * 0.1).astype(np.float32)
        batch["audio_len"][:] = samples
    return batch


def jax_init(cfg, batch, seed):
    """(params, batch_stats) shaped as the JAX model's, drawn with numpy
    (``jit_init``, which compiles nothing) and moved off their init
    (``perturbed``)."""
    model = JaxTrainer(from_dict(cfg)).model
    variables = perturbed(jit_init(model, seed, batch["audio"][0], batch["audio_len"][0],
                                   train=False), seed + 1)
    return (jax.tree.map(np.asarray, variables["params"]),
            jax.tree.map(np.asarray, variables["batch_stats"]))


@pytest.fixture(scope="module")
def cases():
    """JAX's three seq-mesh steps, the port's one-process steps of the
    layers and the ranks' results: one launch of two ranks runs in a thread
    while JAX compiles here."""
    setup, jobs = {}, []
    for i, name in enumerate(MESH_CONFIGS):
        cfg = mesh_config(name)
        batch = {k: v[:1] for k, v in aligned(cfg, 10 + i, ragged=name != "linear").items()}
        params, stats = jax_init(cfg, batch, 30 + i)
        mu, nu = (params_from_jax(t) for t in adam_moments(params))
        weights = from_jax({"params": params, "batch_stats": stats})
        setup[name] = (cfg, batch, params, stats)
        jobs.append((sp_step, (cfg, batch, (mu, nu, ADAM_COUNT), weights)))
    layers = {}
    for i, name in enumerate(LAYERS):
        cfg = layer_config(name)
        layers[name] = (cfg, aligned(cfg, 20 + i), port_adam(cfg))
        jobs.append((sp_step, layers[name]))
    with ThreadPoolExecutor(1 + len(setup)) as pool:
        launched = pool.submit(launch_jobs, jobs, 2)
        futures = {name: pool.submit(jax_sp_step, cfg, params, stats, batch, "1x2")
                   for name, (cfg, batch, params, stats) in setup.items()}
        one = {name: dryrun.shard_step(cfg, batch, 0, adam, None, 1, "cpu", grads=True)
               for name, (cfg, batch, adam) in layers.items()}
        jax_steps = {k: f.result() for k, f in futures.items()}
        outs = launched.result()
    keys = [("mesh", name) for name in setup] + [("layer", name) for name in layers]
    got = {key: [r[i] for r in outs] for i, key in enumerate(keys)}
    return {"jax": jax_steps, "one": one, "got": got}


@pytest.mark.parametrize("case", list(MESH_CONFIGS))
def test_sp_step_matches_jax_seq_mesh(cases, case):
    """The port's data 1 x seq 2 step against JAX's on the same mesh: loss
    and gradient norm within LOSS_RTOL on both ranks, the parameters within
    PARAM_TOL and the running statistics within STATS_TOL of JAX's; the
    step split along time (the seq group's collectives issued, no coverage
    warning)."""
    new_params, new_stats, metrics, shape = cases["jax"][case]
    ranks = cases["got"][("mesh", case)]
    assert shape["seq"] == 2 and len(ranks) == 2
    for r in ranks:
        assert r["seq_size"] == 2 and not r["warnings"]
        assert r["sp_calls"]["all_gather"] > 0 and r["sp_calls"]["reduce_scatter"] > 0
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


# the exchange each layer adds to the seq group's all-gathers and
# reduce-scatters (the conv modules' halos are in every step)
EXCHANGES = {"linear": "all_reduce", "local": "halo", "VGG": "halo"}
CONV_HALOS = 20


@pytest.mark.parametrize("layer", list(LAYERS))
def test_layer_seq_2_step_matches_the_one_process_step(cases, layer):
    """Each layer alone in the shrunk flagship at data 1 x seq 2: the step
    is the port's one-process step within ONE_TOL (the norm within
    RANKS_NORM_TOL), the parameters bit for bit equal across the ranks, the
    step split along time (no coverage warning) with the layer's own
    exchange issued: linear attention's all-reduces, local attention's and
    VGG's extra halos beside the conv modules'."""
    ranks = cases["got"][("layer", layer)]
    assert_matches_one_process(ranks, cases["one"][layer], RANKS_NORM_TOL)
    for r in ranks:
        calls = r["sp_calls"]
        assert not r["warnings"] and calls["all_gather"] > 0 and calls["reduce_scatter"] > 0
        kind = EXCHANGES.get(layer)
        assert (calls["all_reduce"] > 0) == (kind == "all_reduce")
        # the five conv modules' halos, forward and backward, twice a step
        assert (calls["halo"] > CONV_HALOS) == (kind == "halo") and calls["halo"] >= CONV_HALOS


@pytest.mark.parametrize("kind", ["full", "causal", "strided-full", "strided-causal"])
def test_rel_to_abs_rows_match_the_whole_skews(kind):
    """The row-offset skew of a rank's rows against the whole skew's rows:
    every row offset of rel_to_abs_full and of the strided full skew at
    strides 2 and 3, bit for bit; of the causal ones wherever the causal
    mask lets a key through (a future key's column is clamped)."""
    gen = torch.Generator().manual_seed(0)
    for t in (5, 8, 9):
        for s in ((1,) if "strided" not in kind else (2, 3)):
            tq = -(-t // s)
            keys = tq * s
            width = 2 * keys - 1 if kind.endswith("full") else keys
            rel = torch.randn(2, 3, tq, width, generator=gen)
            if kind == "full":
                whole = A.rel_to_abs_full(rel)
            elif kind == "causal":
                whole = A.rel_to_abs_causal(rel)
            elif kind == "strided-full":
                whole = A.rel_to_abs_strided_full(rel, s)
            else:
                whole = A.rel_to_abs_strided_causal(rel, s)
            seen = (torch.ones(tq, keys, dtype=torch.bool) if kind.endswith("full") else
                    torch.arange(keys)[None, :] <= torch.arange(tq)[:, None] * s)
            for first in range(tq):
                for n in range(1, tq - first + 1):
                    rows = A.rel_to_abs_rows(rel[:, :, first:first + n], first, keys, s)
                    ok = seen[first:first + n]
                    assert torch.equal(rows[..., ok], whole[:, :, first:first + n][..., ok])


def asr_configs() -> list:
    out = []
    for path in sorted(glob.glob("configs/*.json")):
        with open(path) as f:
            cfg = json.load(f)
        if "encoder_params" in cfg:
            out.append(path)
    return out


@pytest.mark.parametrize("path", asr_configs())
def test_shipped_configs_take_seq_2(path):
    """Every shipped ASR config's encoder (one block a stage, widths as
    shipped) takes ``shard_encoder_`` at seq 2, refusing nothing, and its
    frame schedule at an ``sp_pad_align``-ed length divides at every
    point."""
    with open(path) as f:
        enc = json.load(f)["encoder_params"]
    stages = len(enc.get("expand_blocks", []))
    cut = dict(enc, num_blocks=stages + 1, expand_blocks=list(range(stages)),
               strided_blocks=list(range(stages)) if enc.get("strided_blocks") else [])
    encoder = ConformerEncoder(cut)
    sequence.shard_encoder_(encoder, Region(None, 0, 2))
    assert encoder.seq == Region(None, 0, 2)
    samples = mesh.sp_pad_align(enc, 2)(160000)
    assert all(f % 2 == 0 for f in mesh.seq_frame_schedule(enc, samples)[1:])
