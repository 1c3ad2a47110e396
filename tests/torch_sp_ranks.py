"""The rank side of tests/test_torch_port_seq_parallel.py: functions that
gloo ranks spawned by parallel/mesh.launch run. This module imports only
the port, so a rank imports nothing of JAX or the JAX package."""

import copy
import warnings

import numpy as np
import torch

from efficientconformer_torch import dryrun
from efficientconformer_torch.parallel import mesh, sequence, tensor
from efficientconformer_torch.parallel.tensor import Region
from efficientconformer_torch.training.trainer import Trainer
from efficientconformer_torch.utils.weights import set_adam_state

RANK_TIMEOUT = 240   # seconds for a launch of two or four ranks
SP_SAMPLES = 20160   # 127 mel frames -> 64 after subsampling -> 32 -> 16 (TINY_ENCODER)


def run_jobs(jobs):
    """In a rank: each (function, args) of ``jobs`` in turn; their results."""
    return [fn(*args) for fn, args in jobs]


def launch_jobs(jobs, world):
    return mesh.launch(run_jobs, world, (jobs,), device_type="cpu", threads=1,
                       timeout=RANK_TIMEOUT)


def with_grid(cfg: dict, seq: int, model: int = 1) -> dict:
    cfg = copy.deepcopy(cfg)
    cfg["training_params"].update(seq_parallel=seq, model_parallel=model)
    return cfg


def sp_step(cfg, batch, adam, weights=None, seq=2, model=1):
    """``dryrun.shard_step`` at seq size ``seq`` (and model size ``model``)
    with its gradients, and the RuntimeWarnings the step raised."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = dryrun.shard_step(with_grid(cfg, seq, model), batch, 0, adam, None, 1, "cpu",
                                weights, grads=True)
    out["warnings"] = [str(w.message) for w in caught if w.category is RuntimeWarning]
    return out


def checkpoint_rank(cfg, batch, adam, path_in, path_out):
    """At seq size 2: load the one-process checkpoint ``path_in``, take a
    step from the Adam state ``adam`` and save to ``path_out`` (written by
    rank 0). The parameters as loaded and after the step, the Adam state,
    and the loss of one more step after the save."""
    trainer = Trainer(with_grid(cfg, 2), device="cpu")
    trainer.load(path_in)
    loaded = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    set_adam_state(trainer.optimizer, trainer.model, *adam)
    trainer.step = adam[2]
    mine = mesh.shard_batch({k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()})
    trainer.train_step(mine)
    trainer.save(path_out)
    out = {"loaded": loaded, "opt": copy.deepcopy(trainer.optimizer.state_dict()),
           "after": {k: v.clone() for k, v in trainer.model.state_dict().items()}}
    out["next_loss"] = float(trainer.train_step(mine)[0])
    return out


# ---------------------------------------------------------------- the operators


def conv_case(stride, length, seed=0):
    """A depthwise Conv1d (6 channels, kernel 7: a halo of 3), its weights
    drawn from ``seed``, an input (B 2, C 6, 2 x ``length``) and the output
    gradient of the whole convolution."""
    from efficientconformer_torch.models.layers import Conv1d

    gen = torch.Generator().manual_seed(seed)
    conv = Conv1d(6, 6, 7, stride=stride, groups=6)
    with torch.no_grad():
        conv.weight.normal_(generator=gen)
        conv.bias.normal_(generator=gen)
    t = 2 * length
    x = torch.randn(2, 6, t, generator=gen)
    dy = torch.randn(2, 6, (t - 1) // stride + 1, generator=gen)
    return conv, x, dy


CONV_CASES = {"stride1-odd-offset": (1, 9), "stride2-odd-offset": (2, 9),
              "stride2-even-offset": (2, 8), "short-share": (1, 2)}


def conv_rank(name):
    """The case's convolution on this rank's frames through ``halo``
    (``sequence.conv1d_time``), its loss the rank's outputs against their
    slice of the output gradient: the output, its span, the gradient of the
    rank's input frames, the weight's and bias's gradients summed over the
    ranks, and the halo's collectives."""
    stride, length = CONV_CASES[name]
    conv, x, dy = conv_case(stride, length)
    seq = sequence.region()
    span = sequence.even(x.shape[-1], seq)
    mine = x[..., span.start:span.start + span.length].clone().requires_grad_()
    sequence.reset_calls()
    y, out = sequence.conv1d_time(conv, mine, span)
    (y * dy[..., out.start:out.start + out.length]).sum().backward()
    grads = {n: tensor.reduce_parts(p.grad, seq.group) for n, p in conv.named_parameters()}
    return {"y": y.detach(), "span": tuple(out[:3]), "dx": mine.grad, "grads": grads,
            "calls": dict(sequence.calls)}


def gather_rank():
    """``gather_time`` and ``split_time`` on this rank: forward against the
    whole, backward by the rule of parallel/sequence.py (gather: the
    replicated side's gradient summed over the seq group; split: the
    gathered gradient over the seq size)."""
    seq = sequence.region()
    gen = torch.Generator().manual_seed(3)
    whole = torch.randn(2, 8, 5, generator=gen)
    dy = torch.randn(2, 8, 5, generator=gen)
    span = sequence.even(8, seq)
    mine = whole[:, span.start:span.start + span.length].clone().requires_grad_()
    sequence.reset_calls()
    g = sequence.gather_time(mine, seq)
    (g * dy).sum().backward()
    rep = whole.clone().requires_grad_()
    s = sequence.split_time(rep, seq)
    (s * dy[:, span.start:span.start + span.length]).sum().backward()
    return {"gathered": g.detach(), "dx_gather": mine.grad, "split": s.detach(),
            "dx_split": rep.grad, "calls": dict(sequence.calls)}


def attention_case(seed=0):
    """A grouped (G = 3) rel-pos attention layer (D 24, H 4), its weights
    drawn from ``seed``, an input (B 2, T 16: 8 frames a rank at seq 2,
    which 3 does not divide), a ragged key mask and an output gradient."""
    from efficientconformer_torch.models.attentions import MultiHeadSelfAttention
    from efficientconformer_torch.models.model_ctc import init_params_
    from efficientconformer_torch.ops import masks as M

    gen = torch.Generator().manual_seed(seed)
    layer = MultiHeadSelfAttention(24, 4, group_size=3, relative_pos_enc=True)
    init_params_(layer, gen)
    x = torch.randn(2, 16, 24, generator=gen)
    mask = M.padding_mask(16, torch.tensor([16, 11]))
    return layer, x, mask, torch.randn(2, 16, 24, generator=gen)


def attention_rank():
    """The grouped layer on this rank's frames, keys and values gathered
    (``gather_time``), its loss the rank's rows against their slice of the
    output gradient: the output, the gradient of the rank's input frames,
    the parameters' gradients summed over the ranks."""
    layer, x, mask, dy = attention_case()
    seq = sequence.region()
    span = sequence.even(16, seq)
    mine = x[:, span.start:span.start + span.length].clone().requires_grad_()
    sequence.reset_calls()
    y = layer(mine, mask, span)
    (y * dy[:, span.start:span.start + span.length]).sum().backward()
    grads = {n: tensor.reduce_parts(p.grad, seq.group)
             for n, p in layer.named_parameters() if p.grad is not None}
    return {"y": y.detach(), "dx": mine.grad, "grads": grads, "calls": dict(sequence.calls)}


def operator_ranks():
    """Every operator case of this module on the seq group of a data 1 x
    seq 2 grid."""
    mesh.make_grid(1, 2)
    return {"conv": {name: conv_rank(name) for name in CONV_CASES},
            "gather": gather_rank(), "attention": attention_rank(),
            "grid": mesh.grid()[:4] + (mesh.seq_rank(), mesh.seq_size())}

