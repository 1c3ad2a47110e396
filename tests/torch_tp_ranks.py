"""The rank side of tests/test_torch_port_tensor_parallel.py: functions that
gloo ranks spawned by parallel/mesh.launch run. This module imports only
the port, so a rank imports nothing of JAX or the JAX package."""

import copy

import numpy as np
import torch

from efficientconformer_torch import dryrun
from efficientconformer_torch.parallel import mesh, tensor
from efficientconformer_torch.training.trainer import Trainer
from efficientconformer_torch.utils.weights import set_adam_state

RANK_TIMEOUT = 240   # seconds for a launch of two or four ranks


def run_jobs(jobs):
    """In a rank: each (function, args) of ``jobs`` in turn; their results."""
    return [fn(*args) for fn, args in jobs]


def launch_jobs(jobs, world):
    return mesh.launch(run_jobs, world, (jobs,), device_type="cpu", threads=1,
                       timeout=RANK_TIMEOUT)


def with_model_parallel(cfg: dict, n: int) -> dict:
    cfg = copy.deepcopy(cfg)
    cfg["training_params"]["model_parallel"] = n
    return cfg


def tp_step(cfg, batch, adam, weights=None, n=2):
    """``dryrun.shard_step`` at model size ``n`` with its gradients."""
    return dryrun.shard_step(with_model_parallel(cfg, n), batch, 0, adam, None, 1, "cpu",
                             weights, grads=True)


def checkpoint_rank(cfg, batch, adam, path_in, path_out):
    """At model size 2: load the one-process checkpoint ``path_in`` (the
    full layout, cut to this rank's shards) and gather its parameters; from
    the Adam state ``adam`` take a step and save to ``path_out`` (written
    whole by rank 0). The gathered parameters as loaded and after the step,
    the gathered Adam state, the rank's shapes, and the loss of one more
    step after the save."""
    trainer = Trainer(with_model_parallel(cfg, 2), device="cpu")
    trainer.load(path_in)
    loaded = {k: v.clone() for k, v in tensor.gather_state_dict(trainer.model).items()}
    set_adam_state(trainer.optimizer, trainer.model, *adam)
    trainer.step = adam[2]
    mine = mesh.shard_batch({k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()})
    trainer.train_step(mine)
    trainer.save(path_out)
    out = {"loaded": loaded,
           "opt": copy.deepcopy(tensor.gather_optimizer_state(trainer.optimizer, trainer.model)),
           "after": {k: v.clone() for k, v in tensor.gather_state_dict(trainer.model).items()},
           "shapes": {n: tuple(p.shape) for n, p in trainer.model.named_parameters()}}
    # saving leaves the optimizer's state as the shards: training goes on
    out["next_loss"] = float(trainer.train_step(mine)[0])
    return out


ATTENTION_VARIANTS = {
    # name: (MultiHeadSelfAttentionModule keyword arguments, full (T, T) mask)
    "strided": (dict(relative_pos_enc=True, stride=2), False),
    "absolute": (dict(relative_pos_enc=False), False),
    "absolute-grouped": (dict(relative_pos_enc=False, group_size=3), False),
    "even-group": (dict(relative_pos_enc=True, group_size=2), False),
    "causal": (dict(relative_pos_enc=True, causal=True), True),
}


def attention_case(name, seed=0):
    """An attention module (D 24, H 4) of a variant, its weights drawn from
    ``seed``, an input (B 2, T 9), a ragged key mask (or a causal one) and
    an output gradient."""
    from efficientconformer_torch.models.model_ctc import init_params_
    from efficientconformer_torch.models.modules import MultiHeadSelfAttentionModule
    from efficientconformer_torch.ops import masks as M

    kwargs, causal = ATTENTION_VARIANTS[name]
    gen = torch.Generator().manual_seed(seed)
    module = MultiHeadSelfAttentionModule(24, 4, 0.0, **kwargs)
    init_params_(module, gen)
    lengths = torch.tensor([9, 6])
    mask = M.look_ahead_mask(9, lengths) if causal else M.padding_mask(9, lengths)
    x = torch.randn(2, 9, 24, generator=gen)
    t_out = -(-9 // kwargs.get("stride", 1))
    return module, x, mask, torch.randn(2, t_out, 24, generator=gen)


def attention_rank(name):
    """The variant's forward and backward on this rank's shards (model
    size 2): the output, the input's gradient and the parameters' gradients
    gathered whole."""
    module, x, mask, dy = attention_case(name)
    tensor.shard_model_(module, tensor.Region(mesh.model_group(), mesh.model_rank(), 2))
    x = x.requires_grad_()
    y = module(x, mask)
    (y * dy).sum().backward()
    named = dict(module.named_parameters())
    grads = {n: p.grad for n, p in named.items() if p.grad is not None}
    return {"y": y.detach(), "dx": x.grad, "grads": tensor.gather_tensors(module, grads)}


def attention_ranks(names):
    mesh.make_grid(2)
    return [attention_rank(name) for name in names]


CACHE_HEADS = {"whole-heads": 4, "gather": 3}   # heads of the (D 24) causal layer: 2 or 1.5 a rank
CACHE_FRAMES, CACHE_SLOTS, CONV_KERNEL = 6, 8, 5


def cache_layers(heads, state):
    """A causal rel-pos attention layer (D 24, ``heads`` heads) and a causal
    convolution module (D 24, kernel CONV_KERNEL) in eval mode, named as a
    block holds them (``mhsa``, ``convolution_module``), with the weights of
    ``state``."""
    from torch import nn

    from efficientconformer_torch.models.attentions import MultiHeadSelfAttention
    from efficientconformer_torch.models.modules import ConvolutionModule

    layers = nn.ModuleDict({
        "mhsa": MultiHeadSelfAttention(24, heads, causal=True, relative_pos_enc=True),
        "convolution_module": ConvolutionModule(24, 24, CONV_KERNEL, 0.0, causal=True)})
    layers.load_state_dict(state, strict=True)
    return layers.eval()


def run_cached(layers, x):
    """The attention's growing cache over two chunks (4 + 2 frames, no
    mask), its fixed-capacity step token by token (CACHE_SLOTS slots), the
    convolution module's step frame by frame: outputs and cache widths."""
    from efficientconformer_torch.models.attentions import step_positions

    att, conv = layers["mhsa"], layers["convolution_module"]
    b = x.shape[0]
    with torch.no_grad():
        o1, hidden = att.forward_cached(x[:, :4], None, None)
        o2, hidden = att.forward_cached(x[:, 4:], None, hidden)
        width = att.cache_width()
        k, v = torch.zeros(b, CACHE_SLOTS, width), torch.zeros(b, CACHE_SLOTS, width)
        state = torch.zeros(b, conv.layers[4].in_channels, CONV_KERNEL - 1)
        steps, convs = [], []
        for t in range(x.shape[1]):
            steps.append(att.step(x[:, t:t + 1], k, v, step_positions(torch.full((b,), t),
                                                                     CACHE_SLOTS)))
            y, state = conv.step(x[:, t:t + 1], state)
            convs.append(y)
    return {"cached": torch.cat([o1, o2], 1), "step": torch.cat(steps, 1),
            "conv": torch.cat(convs, 1), "hidden_width": hidden["k"].shape[-1],
            "cache_width": width, "state_width": state.shape[1]}


def cached_ranks(states, x):
    """At model size 2: ``run_cached`` of each CACHE_HEADS case on this
    rank's shards, from the whole layers' weights ``states``."""
    mesh.make_grid(2)
    out = {}
    for name, heads in CACHE_HEADS.items():
        layers = cache_layers(heads, states[name])
        tensor.shard_model_(layers, tensor.Region(mesh.model_group(), mesh.model_rank(), 2))
        out[name] = run_cached(layers, x)
    return out
