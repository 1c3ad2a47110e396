"""PyTorch port vs the JAX package: the Transducer, on the CPU in fp32.

The prediction network, the joint network (all three modes of
tests/test_models.py), the lattice of a narrowed EfficientConformerTransducer
Small, greedy decoding (both loops, a tight token budget, cap 0), the weight
bridge, one training step against JAX ``Trainer.train_step_fn()`` and the
variational noise. The port's weights come from a seeded generator; the JAX
variables are made from its state_dict by utils/torch_compat.
convert_transducer. Inputs come from numpy with fixed seeds.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from efficientconformer_tpu.config import from_dict
from efficientconformer_tpu.models.decoders import RnnDecoder as JaxRnnDecoder
from efficientconformer_tpu.models.joint_networks import JointNetwork as JaxJoint
from efficientconformer_tpu.models.transducer import Transducer as JaxTransducer
from efficientconformer_tpu.models.transducer import greedy_decode as jax_greedy_decode
from efficientconformer_tpu.models.transducer import greedy_decode_stream
from efficientconformer_tpu.runtime import greedy_token_cap as jax_greedy_token_cap
from efficientconformer_tpu.training.trainer import Trainer as JaxTrainer
from efficientconformer_tpu.training.trainer import TrainerState
from efficientconformer_tpu.utils import torch_compat as TC
from efficientconformer_torch.models import layers
from efficientconformer_torch.models.decoders import RnnDecoder, make_decoder
from efficientconformer_torch.models.joint_networks import JointNetwork
from efficientconformer_torch.models.model_ctc import init_params_
from efficientconformer_torch.models.transducer import (
    Transducer,
    build_model,
    decode_frames,
    greedy_decode,
    greedy_token_cap,
)
from efficientconformer_torch.training.trainer import Trainer
from efficientconformer_torch.utils.weights import from_jax, load_adam_state, params_from_jax
from test_torch_port_model import LOGITS_TOL, perturb_norms_, ragged_audio, valid_frames
from test_torch_port_training import adam_moments, rel_err, with_adam_state

TRANSDUCER = "configs/EfficientConformerTransducerSmall.json"
VOCAB = 16
LOSS_RTOL = 1e-5     # fp32 loss, same arithmetic in another order
PARAM_TOL = 1e-5     # one Adam update from a shared non-zero state, lr ~ 1e-3
STATS_TOL = 1e-4     # BatchNorm running statistics, relative to max(|x|, 1)
JOINTS = [
    {"joint_mode": "sum", "dim_model": 12, "act": "tanh"},
    {"joint_mode": "concat", "dim_model": 12, "act": "tanh"},
    {"joint_mode": "concat", "dim_model": None, "act": "tanh"},  # identity projection
]


def narrow_transducer() -> dict:
    """Transducer Small cut to 5 blocks and narrow widths (3 stages, G = 3 in
    stage 1, strided and expand blocks [1, 3]), a 16-wide prediction network
    and joint over a 16-token vocabulary."""
    with open(TRANSDUCER) as f:
        cfg = json.load(f)
    cfg["encoder_params"].update(num_blocks=5, dim_model=[24, 36, 48], num_heads=4,
                                 subsampling_filters=[8], strided_blocks=[1, 3],
                                 expand_blocks=[1, 3], kernel_size=7)
    cfg["decoder_params"].update(dim_model=16, vocab_size=VOCAB)
    cfg["joint_params"] = dict(JOINTS[0])
    cfg["tokenizer_params"]["vocab_size"] = VOCAB
    return cfg


def port_transducer(cfg, seed=0) -> Transducer:
    model = Transducer(cfg["encoder_params"], cfg["decoder_params"], cfg["joint_params"], VOCAB)
    init_params_(model, torch.Generator().manual_seed(seed))
    perturb_norms_(model, seed + 1)
    return model.eval()


def jax_model_and_variables(cfg, model):
    jm = JaxTransducer(encoder_params=cfg["encoder_params"], decoder_params=cfg["decoder_params"],
                       joint_params=cfg["joint_params"], vocab_size=VOCAB)
    params, stats = TC.convert_transducer(model.state_dict())
    return jm, {"params": jax.tree.map(jnp.asarray, params),
                "batch_stats": jax.tree.map(jnp.asarray, stats)}


def labels_case(b, u, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(1, VOCAB, (b, u)).astype(np.int32)
    y_len = np.linspace(0, u, b).astype(np.int32)
    labels[np.arange(u)[None] >= y_len[:, None]] = 0
    return labels, y_len


# ------------------------------------------------------------ the pieces


def test_rnn_decoder_matches_jax():
    """The teacher-forced pass (id 0 embeds to zeros) and three steps with
    an explicit carry."""
    params = {"arch": "RNN", "num_layers": 2, "dim_model": 10, "vocab_size": VOCAB}
    dec = RnnDecoder(params)
    init_params_(dec, torch.Generator().manual_seed(3))
    variables = {"params": TC.convert_rnn_decoder(
        {k: v.numpy() for k, v in dec.state_dict().items()}, prefix="")}
    jdec = JaxRnnDecoder(params=params)
    y = np.array([[0, 3, 5, 0, 9], [0, 15, 1, 2, 0]], np.int32)
    want = jdec.apply(variables, jnp.asarray(y))
    with torch.no_grad():
        got = dec(torch.from_numpy(y).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)

    carry = jdec.apply(variables, 2, method=JaxRnnDecoder.init_carry)
    tcarry = dec.init_carry(2, "cpu")
    for tok in ([0, 0], [3, 7], [12, 0]):
        jg, carry = jdec.apply(variables, jnp.asarray(tok, jnp.int32), carry,
                               method=JaxRnnDecoder.step)
        with torch.no_grad():
            tg, tcarry = dec.step(torch.tensor(tok), tcarry)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
        for a, b in zip(tcarry, carry):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)


@pytest.mark.parametrize("joint", JOINTS, ids=["sum", "concat", "concat-identity"])
def test_joint_network_matches_jax(joint):
    """Lattice, step and row modes on the same frames and states."""
    de, dd = (12, 12) if joint["dim_model"] is None else (10, 14)
    net = JointNetwork(de, dd, VOCAB, joint)
    init_params_(net, torch.Generator().manual_seed(4))
    variables = {"params": TC.convert_joint({k: v.numpy() for k, v in net.state_dict().items()},
                                            prefix="")}
    jnet = JaxJoint(vocab_size=VOCAB, params=joint)
    rng = np.random.default_rng(5)
    f = rng.standard_normal((2, 6, de)).astype(np.float32)
    g = rng.standard_normal((2, 4, dd)).astype(np.float32)
    with torch.no_grad():
        tf, tg = torch.from_numpy(f), torch.from_numpy(g)
        got = {"lattice": net(tf, tg), "step": net.step(tf[:, 2], tg[:, 1]),
               "row": net.row(net.project_encoder(tf), tg[:, 3])}
    want = {"lattice": jnet.apply(variables, jnp.asarray(f), jnp.asarray(g)),
            "step": jnet.apply(variables, jnp.asarray(f[:, 2]), jnp.asarray(g[:, 1]),
                               method=JaxJoint.step),
            "row": jnet.apply(variables, jnet.apply(variables, jnp.asarray(f),
                                                    method=JaxJoint.project_encoder),
                              jnp.asarray(g[:, 3]), method=JaxJoint.row)}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5,
                                   err_msg=k)


def test_narrowed_transducer_lattice_matches_jax():
    cfg = narrow_transducer()
    model = port_transducer(cfg)
    jm, variables = jax_model_and_variables(cfg, model)
    x, x_len = ragged_audio(3, 9000, seed=1)
    y, y_len = labels_case(3, 5, seed=2)
    want, want_len = jax.jit(lambda v, *a: jm.apply(v, *a))(
        variables, *map(jnp.asarray, (x, y, x_len, y_len)))
    with torch.no_grad():
        got, got_len = model(*(torch.from_numpy(a) for a in (x, y, x_len, y_len)))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    for g_, w_ in zip(valid_frames(got.numpy(), got_len), valid_frames(np.asarray(want),
                                                                       got_len)):
        np.testing.assert_allclose(g_, w_, rtol=0, atol=LOGITS_TOL)


def test_full_width_transducer_small_matches_jax():
    """EfficientConformerTransducerSmall at its published widths (head
    widths 75/35/50) on 1 s of audio: the lattice."""
    with open(TRANSDUCER) as f:
        cfg = json.load(f)
    model = build_model(TRANSDUCER, "cpu", torch.float32, torch.Generator().manual_seed(11))
    perturb_norms_(model, 12)
    jm = JaxTransducer(encoder_params=cfg["encoder_params"],
                       decoder_params=cfg["decoder_params"],
                       joint_params=cfg["joint_params"], vocab_size=1000)
    params, stats = TC.convert_transducer(model.state_dict())
    variables = {"params": params, "batch_stats": stats}
    x, x_len = ragged_audio(2, 16000, seed=5)
    y = np.array([[5, 999, 17], [3, 0, 0]], np.int32)
    y_len = np.array([3, 1], np.int32)
    want, want_len = jax.jit(lambda v, *a: jm.apply(v, *a))(
        variables, *map(jnp.asarray, (x, y, x_len, y_len)))
    with torch.no_grad():
        got, got_len = model(*(torch.from_numpy(a) for a in (x, y, x_len, y_len)))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    for g_, w_ in zip(valid_frames(got.numpy(), got_len), valid_frames(np.asarray(want),
                                                                       got_len)):
        np.testing.assert_allclose(g_, w_, rtol=0, atol=LOGITS_TOL)


# ------------------------------------------------------------ greedy decoding


@pytest.fixture(scope="module")
def decode_case():
    """A narrowed Transducer, its JAX twin and a ragged batch."""
    cfg = narrow_transducer()
    model = port_transducer(cfg, seed=6)
    jm, variables = jax_model_and_variables(cfg, model)
    x, x_len = ragged_audio(3, 12000, seed=7)
    return cfg, model, jm, variables, x, x_len


def test_greedy_decode_matches_jax(decode_case):
    """End to end from the waveforms, label-looping, the token cap of the
    runtime."""
    cfg, model, jm, variables, x, x_len = decode_case
    cap = greedy_token_cap(cfg["encoder_params"], x.shape[1], 5)
    assert cap == jax_greedy_token_cap(from_dict(cfg), x.shape[1], 5)
    want_tok, want_n = jax_greedy_decode(jm, variables, jnp.asarray(x), jnp.asarray(x_len),
                                         max_tokens=cap)
    got_tok, got_n = greedy_decode(model, torch.from_numpy(x), torch.from_numpy(x_len), cap)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    assert got_n.min() > 0


@pytest.mark.parametrize("algo", ["label", "frame"])
@pytest.mark.parametrize("max_tokens,cap", [(128, 5), (3, 2), (128, 0)],
                         ids=["full", "tight-budget", "cap-0"])
def test_greedy_loops_match_jax(decode_case, algo, max_tokens, cap):
    """Both loops over the same encoder frames as the JAX loops
    (greedy_decode_stream from frame 0 is the full decode): the full budget,
    a tight budget that clips, and the degenerate cap 0 that never emits."""
    cfg, model, jm, variables, x, x_len = decode_case
    with torch.no_grad():
        f, f_len = model.encoder(torch.from_numpy(x), torch.from_numpy(x_len))
    state = greedy_decode_stream(jm, variables, jnp.asarray(f.numpy()),
                                 jnp.asarray(f_len.numpy()), max_tokens=max_tokens,
                                 max_consec_dec_steps=cap, algo=algo)
    got_tok, got_n = decode_frames(model, f, f_len, max_tokens, cap, algo)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(state["n_tok"]))
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(state["tokens"]))
    if cap == 0:
        assert (got_n == 0).all()
    other, other_n = decode_frames(model, f, f_len, max_tokens, cap,
                                   "frame" if algo == "label" else "label")
    assert torch.equal(got_n, other_n) and torch.equal(got_tok, other)


# ------------------------------------------------------------ weights


def test_weight_bridge_round_trip():
    """convert_transducer(from_jax(v)) == v leaf for leaf; the port loads
    from_jax of its own converted state_dict with strict=True."""
    from test_torch_port_guards import assert_trees_equal

    model = build_model(TRANSDUCER, "cpu", torch.float32, torch.Generator().manual_seed(2))
    sd = model.state_dict()
    for key in ("decoder.embedding.weight", "decoder.rnn.weight_ih_l0", "decoder.rnn.bias_hh_l0",
                "joint_network.linear_encoder.weight", "joint_network.linear_joint.bias"):
        assert key in sd, key
    params, stats = TC.convert_transducer(sd)
    back = from_jax({"params": params, "batch_stats": stats})
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape and back[k].dtype == v.dtype, k
        torch.testing.assert_close(back[k], v, rtol=0, atol=0, msg=k)
    params2, stats2 = TC.convert_transducer(back)
    assert_trees_equal({"params": params2, "batch_stats": stats2},
                       {"params": params, "batch_stats": stats})
    model.load_state_dict(back, strict=True)


# ------------------------------------------------------------ training


def train_config(**training) -> dict:
    cfg = narrow_transducer()
    cfg["encoder_params"].update(Pdrop=0.0, spec_augment=False)
    cfg["training_params"].update({"mixed_precision": False, "warmup_steps": 20,
                                   "accumulated_steps": 2, **training})
    return cfg


def train_batch(seed=0):
    """Two stacked microbatches of 3 ragged utterances with a label-free one."""
    rng = np.random.default_rng(seed)
    a, b, t, u = 2, 3, 12000, 4
    audio = (rng.standard_normal((a, b, t)) * 0.1).astype(np.float32)
    audio_len = np.array([[12000, 9000, 7000], [11000, 12000, 6000]], np.int32)
    audio[np.arange(t)[None, None] >= audio_len[..., None]] = 0.0
    labels = rng.integers(1, VOCAB, (a, b, u)).astype(np.int32)
    label_len = np.array([[4, 2, 0], [3, 4, 1]], np.int32)
    labels[np.arange(u)[None, None] >= label_len[..., None]] = 0
    return {"audio": audio, "audio_len": audio_len, "labels": labels, "label_len": label_len}


def test_train_step_matches_jax():
    """Loss, global gradient norm, updated parameters and BatchNorm running
    statistics after one accumulated Adam step (A = 2), from the same
    weights and the same non-zero Adam state."""
    cfg = train_config()
    port = Trainer(cfg, device="cpu", seed=0)
    params, stats = (jax.tree.map(np.array, t)
                     for t in TC.convert_transducer(port.model.state_dict()))
    jt = JaxTrainer(from_dict(cfg))
    jparams = jax.tree.map(jnp.asarray, params)
    mu, nu = adam_moments(params)
    opt_state = with_adam_state(jt.tx.init(jparams), mu, nu, 10)
    load_adam_state(port.optimizer, port.model, mu, nu, 10)
    port.step = 10
    state = TrainerState(params=jparams, batch_stats=jax.tree.map(jnp.asarray, stats),
                         opt_state=opt_state, step=jnp.asarray(10, jnp.int32))
    batch = train_batch()
    new, metrics = jt.train_step_fn()(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                      jax.random.PRNGKey(0))
    loss, grad_norm = port.train_step(batch)
    np.testing.assert_allclose(float(loss), float(metrics["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(grad_norm), float(metrics["grad_norm"]), rtol=LOSS_RTOL)
    want = params_from_jax(jax.tree.map(np.asarray, new.params))
    start = params_from_jax(params)
    for name, p in port.model.named_parameters():
        torch.testing.assert_close(p.detach(), want[name], rtol=0, atol=PARAM_TOL, msg=name)
        if name.startswith(("decoder.", "joint_network.")):
            assert (p.detach() - start[name]).abs().max().item() > 0.0, name
    _, got_stats = TC.convert_transducer(port.model.state_dict())
    flat_got = jax.tree_util.tree_leaves_with_path(got_stats)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, new.batch_stats)))
    assert len(flat_got) == len(flat_want)
    for path, got in flat_got:
        want_ = torch.from_numpy(np.array(flat_want[path]))
        assert rel_err(torch.from_numpy(np.array(got)), want_) <= STATS_TOL, path


def test_fit_trains_a_transducer():
    cfg = train_config(lr_schedule="Constant", lr_value=3e-3, mixed_precision=True)
    cfg["encoder_params"].update(Pdrop=0.1, spec_augment=True)
    trainer = Trainer(cfg, device="cpu", seed=1)
    losses = trainer.fit(iter([train_batch(seed=3)] * 8), steps=8)
    assert trainer.step == 8 and all(np.isfinite(losses)) and losses[-1] < losses[0]


# ------------------------------------------------------------ variational noise


def test_variational_noise_is_added_to_the_decoder_and_joint_weights():
    """A draw set on the port gives the lattice of the JAX model whose
    prediction and joint weights (embedding, w_ih, w_hh and the three Dense
    kernels, no bias) carry the same noise: w + vn_std * noise."""
    vn_std = 0.3
    cfg = narrow_transducer()
    model = Transducer(cfg["encoder_params"], cfg["decoder_params"], cfg["joint_params"], VOCAB,
                       vn_std=vn_std)
    init_params_(model, torch.Generator().manual_seed(8))
    model.eval()
    layers.draw_variational_noise_(model, torch.Generator().manual_seed(9))
    noised = {}
    for name, m in model.named_modules():
        if isinstance(m, layers.VariationalNoise) and m.vn_noise is not None:
            for w, n in m.vn_noise.items():
                noised[f"{name}.{w}"] = n
    assert sorted(noised) == sorted([
        "decoder.embedding.weight", "decoder.rnn.weight_ih_l0", "decoder.rnn.weight_hh_l0",
        "joint_network.linear_encoder.weight", "joint_network.linear_decoder.weight",
        "joint_network.linear_joint.weight"])
    sd = {k: v + vn_std * noised[k] if k in noised else v for k, v in model.state_dict().items()}
    jm = JaxTransducer(encoder_params=cfg["encoder_params"], decoder_params=cfg["decoder_params"],
                       joint_params=cfg["joint_params"], vocab_size=VOCAB)
    params, stats = TC.convert_transducer(sd)
    x, x_len = ragged_audio(2, 8000, seed=10)
    y, y_len = labels_case(2, 4, seed=11)
    want, _ = jax.jit(lambda v, *a: jm.apply(v, *a))(
        {"params": params, "batch_stats": stats}, *map(jnp.asarray, (x, y, x_len, y_len)))
    args = [torch.from_numpy(a) for a in (x, y, x_len, y_len)]
    with torch.no_grad():
        got, got_len = model(*args)
        layers.clear_variational_noise_(model)
        clean, _ = model(*args)
    for g_, w_ in zip(valid_frames(got.numpy(), got_len), valid_frames(np.asarray(want),
                                                                       got_len)):
        np.testing.assert_allclose(g_, w_, rtol=0, atol=LOGITS_TOL)
    assert (got - clean).abs().max().item() > 1e-2


def test_trainer_draws_the_noise_once_per_step_from_vn_start_step():
    """Off before vn_start_step; from it on, one draw per step on the
    decoder and joint only, the same for both microbatches of a step, a new
    one the next step, cleared after each step."""
    cfg = train_config(vn_std=0.075, vn_start_step=1)
    trainer = Trainer(cfg, device="cpu", seed=2)
    seen = []

    def record(module, _inputs):
        seen.append((trainer.step, module.vn_noise and {k: v.clone() for k, v in
                                                        module.vn_noise.items()}))

    trainer.model.decoder.embedding.register_forward_pre_hook(record)
    batch = train_batch(seed=4)
    for _ in range(3):
        trainer.train_step(batch)
    steps = [s for s, _ in seen]
    assert steps == [0, 0, 1, 1, 2, 2]
    assert seen[0][1] is None and seen[1][1] is None
    first, second = seen[2][1]["weight"], seen[4][1]["weight"]
    assert torch.equal(first, seen[3][1]["weight"]) and torch.equal(second, seen[5][1]["weight"])
    assert not torch.equal(first, second)
    assert all(m.vn_noise is None for m in trainer.model.modules()
               if isinstance(m, layers.VariationalNoise))
    assert all(m.vn_std is None for m in trainer.model.encoder.modules()
               if isinstance(m, layers.VariationalNoise))
    assert trainer.model.joint_network.linear_joint.vn_std == 0.075


def test_every_decoder_builds_and_steps():
    """The Transformer decoder builds (the LM-Transformer's) and steps on a
    fixed-capacity cache and on the growing cache (carry None, the host
    Transducer beam's), with and without variational noise on its blocks;
    the Conformer decoder builds and steps on its caches, its step the
    last frame of its forward over the tokens
    (tests/test_torch_port_variants.py holds both to the JAX package); an
    unknown arch raises."""
    params = {"arch": "Transformer", "num_blocks": 1, "dim_model": 8, "ff_ratio": 2,
              "num_heads": 2, "Pdrop": 0.0, "relative_pos_enc": True, "max_pos_encoding": 16,
              "vocab_size": VOCAB}
    with torch.no_grad():
        out, carry = make_decoder(params).eval().step(torch.zeros(2, dtype=torch.long), None)
    assert out.shape == (2, 8) and len(carry) == 1 and carry[0]["k"].shape == (2, 1, 8)
    noisy = make_decoder(params, vn_std=0.1).eval()
    assert noisy.blocks[0].feed_forward_module.layers[1].vn_std == 0.1
    assert noisy.embedding.vn_std is None
    conformer = make_decoder(dict(params, arch="Conformer", kernel_size=3)).eval()
    y = torch.tensor([[0, 3, 1], [0, 2, 2]])
    with torch.no_grad():
        full = conformer(y, torch.tensor([3, 3]))
        carry = conformer.init_carry(2, "cpu", 4)
        for u in range(3):
            g, carry = conformer.step(y[:, u], carry)
    torch.testing.assert_close(g, full[:, 2], rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="arch"):
        make_decoder(dict(params, arch="GRU"))
