"""Tensor parallelism: Megatron-style column- and row-parallel layers over
the model groups of parallel/mesh.py's grid.

Counterpart of the JAX package's "model" mesh axis (parallel/mesh.py:82-121,
``param_spec`` and ``shard_params``), where GSPMD inserts the collectives
that the parameters' shardings imply. Here the split is explicit, as in
Megatron-LM, since DTensor has no sharding rule for the port's kernel
``autograd.Function``s:

- the conjugate operators, ``autograd.Function``s over a model group
  (``Region``): ``copy_to_region`` (identity forward, all-reduce backward),
  ``reduce_from_region`` (all-reduce forward, identity backward),
  ``gather_features`` (all-gather forward, the rank's slice backward) and
  ``scatter_features`` (the rank's slice forward, all-gather backward). A
  replicated tensor that enters a sharded computation goes through
  ``copy_to_region`` (its gradient is then summed over the ranks' parts), or
  through ``scatter_features`` when each rank takes only its slice of it;
- the placement of every parameter and buffer by the JAX rule
  (``placement_of``): the first linear of each pair column-parallel (its
  output features, a torch weight's rows, sharded), the second row-parallel
  (its input features sharded, its bias replicated), everything else
  replicated, and a width the model size does not divide replicated too.
  Two departures, by channel where the JAX package replicates: the
  convolution module's depthwise conv and BatchNorm, which act per channel
  on the rank's channels (where its width splits; replicated with the rest
  of the module otherwise). ``pw1``'s column split keeps GLU's halves
  aligned: rank r holds value channels [rE/n, (r+1)E/n) and the same gate
  channels E + [rE/n, (r+1)E/n);
- ``shard_state_dict`` and ``gather_state_dict`` between the full layout
  and a rank's shards (checkpoints, weights from the JAX package), and the
  optimizer's state alike;
- ``shard_model_``, which takes a model built whole (from the same seed on
  every rank) to this rank's shards and sets each layer's parallel form
  (models/layers.py, modules.py, attentions.py, model_ctc.py, lm.py,
  joint_networks.py). A layer whose width the model size does not divide
  runs replicated, as the JAX package's GSPMD runs it: its weights whole on
  every rank, its input entering no region, its gradients averaged over the
  model group with the other replicated parameters'. An attention layer
  whose heads are not whole on a rank takes the gather path
  (models/attentions.py).

Over gloo (the CPU, or ranks sharing one card, where gloo takes the CUDA
tensors as they are) half-precision tensors travel as fp32. Each collective
adds one to ``calls["all_reduce"]`` or ``calls["all_gather"]``.
"""

from __future__ import annotations

import re
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn

from efficientconformer_torch.parallel import mesh

calls = {"all_reduce": 0, "all_gather": 0}


def reset_calls() -> None:
    calls["all_reduce"] = calls["all_gather"] = 0


class Region(NamedTuple):
    """A model group: its process group, this rank's index in it and its size."""

    group: Optional[object]
    rank: int
    size: int


def region() -> Region:
    """This process's model group, from parallel/mesh.py's grid."""
    g = mesh.grid()
    return Region(g.model_group, g.model_rank, g.model_size)


# ---------------------------------------------------------------- collectives


def wire(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it travels: over gloo half precision as fp32."""
    if dist.get_backend(group) == "gloo" and x.dtype in (torch.bfloat16, torch.float16):
        x = x.float()
    return x.contiguous()


def reduce_parts(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks, a new tensor (no autograd,
    uncounted)."""
    y = wire(x, group)
    if y is x:
        y = x.clone()
    dist.all_reduce(y, group=group)
    return y.to(x.device, x.dtype)


def gather_parts(x: torch.Tensor, reg) -> list:
    """Every rank's ``x`` (one shape on every rank), in rank order, over the
    group of ``reg`` (a Region: group, rank, size; no autograd, uncounted)."""
    y = wire(x, reg.group)
    if dist.get_backend(reg.group) == "nccl":
        out = torch.empty((reg.size,) + tuple(y.shape), dtype=y.dtype, device=y.device)
        dist.all_gather_into_tensor(out, y, group=reg.group)
        parts = list(out.unbind(0))
    else:
        parts = [torch.empty_like(y) for _ in range(reg.size)]
        dist.all_gather(parts, y, group=reg.group)
    return [t.to(x.device, x.dtype) for t in parts]


def all_reduce(x: torch.Tensor, reg: Region) -> torch.Tensor:
    """The sum of ``x`` over the region's ranks, a new tensor (no autograd)."""
    calls["all_reduce"] += 1
    return reduce_parts(x, reg.group)


def all_gather(x: torch.Tensor, reg: Region, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (no autograd)."""
    calls["all_gather"] += 1
    return torch.cat(gather_parts(x, reg), dim=dim)


def _slice(x: torch.Tensor, reg: Region, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    if n % reg.size:
        raise ValueError(f"a width of {n} does not split over {reg.size} ranks")
    c = n // reg.size
    return x.narrow(dim, reg.rank * c, c)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, reg):
        ctx.reg = reg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.reg), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, reg):
        return all_reduce(x, reg)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, reg, dim):
        ctx.reg, ctx.dim = reg, dim
        return all_gather(x, reg, dim)

    @staticmethod
    def backward(ctx, grad):
        return _slice(grad, ctx.reg, ctx.dim).contiguous(), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, reg, dim):
        ctx.reg, ctx.dim = reg, dim
        return _slice(x, reg, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, ctx.reg, ctx.dim), None, None


def copy_to_region(x: torch.Tensor, reg: Region) -> torch.Tensor:
    """A replicated tensor entering the ranks' parallel work: the identity,
    and its gradient summed over the ranks."""
    return _Copy.apply(x, reg) if reg.size > 1 else x


def reduce_from_region(x: torch.Tensor, reg: Region) -> torch.Tensor:
    """The ranks' partial results summed: replicated, its gradient passed to
    each part as it is."""
    return _Reduce.apply(x, reg) if reg.size > 1 else x


def gather_features(x: torch.Tensor, reg: Region, dim: int = -1) -> torch.Tensor:
    """The ranks' slices concatenated along ``dim``: replicated; the
    gradient's slice goes back to each rank."""
    return _Gather.apply(x, reg, dim % x.dim()) if reg.size > 1 else x


def scatter_features(x: torch.Tensor, reg: Region, dim: int = -1) -> torch.Tensor:
    """This rank's slice along ``dim`` of a replicated tensor; the ranks'
    gradients are gathered into the whole tensor's."""
    return _Scatter.apply(x, reg, dim % x.dim()) if reg.size > 1 else x


# ---------------------------------------------------------------- placement


class Placement(NamedTuple):
    """How a parameter or buffer is split over a model group: ``kind``
    "column" (a Linear's or pointwise conv's output features, dim 0),
    "row" (its input features, dim 1), "channel" (per-channel weights,
    dim 0) or "replicated"; ``glu`` for pw1's aligned halves."""

    kind: str
    dim: int = -1
    glu: bool = False


REPLICATED = Placement("replicated")

# (pattern of the port's name, placement, the dim whose width must split);
# the JAX names in comments (mesh.py:_COL_PARALLEL, _ROW_PARALLEL)
_RULES = (
    (r"feed_forward_module\d?\.layers\.1\.(weight|bias)", Placement("column", 0), 0),  # fc1
    (r"feed_forward_module\d?\.layers\.[34]\.weight", Placement("row", 1), 1),         # fc2
    (r"mhsa\.(query|key|value)_layer\.(weight|bias)", Placement("column", 0), 0),
    (r"mhsa\.output_layer\.weight", Placement("row", 1), 1),                           # output
    (r"convolution_module\.layers\.2\.(weight|bias)", Placement("column", 0, True), 0),  # pw1
    (r"convolution_module\.layers\.4\.(weight|bias)", Placement("channel", 0), 0),       # dw
    (r"convolution_module\.layers\.5\.(weight|bias|running_mean|running_var)",
     Placement("channel", 0), 0),                                                      # bn
    (r"convolution_module\.layers\.7\.weight", Placement("row", 1), 1),                # pw2
    (r"(^|\.)fc\.(weight|bias)", Placement("column", 0), 0),
    (r"joint_network\.linear_(encoder|decoder|joint)\.(weight|bias)", Placement("column", 0), 0),
)
_COMPILED = [(re.compile(p + "$"), pl, d) for p, pl, d in _RULES]


def placement_of(name: str, shape, n: int) -> Placement:
    """The placement of the parameter or buffer ``name`` (the port's name)
    of full ``shape`` over ``n`` ranks: the JAX rule (mesh.py:82-111),
    with its fallback to replication where the width does not split."""
    if n == 1:
        return REPLICATED
    for pattern, pl, d in _COMPILED:
        if pattern.search(name) and len(shape) > d:
            width = shape[d] // 2 if pl.glu else shape[d]
            return pl if shape[d] % (2 if pl.glu else 1) == 0 and width % n == 0 \
                else REPLICATED
    return REPLICATED


def param_placement(model: nn.Module, n: Optional[int] = None) -> dict:
    """``placement_of`` every parameter and buffer of ``model`` by name
    over ``n`` ranks (by default this process's model size), the port's
    ``param_spec``. A sharded model reports the placement it was split by."""
    if getattr(model, "tp_placement", None) is not None:
        return dict(model.tp_placement)
    n = mesh.model_size() if n is None else n
    named = list(model.named_parameters()) + list(model.named_buffers())
    return {name: placement_of(name, tuple(t.shape), n) for name, t in named}


def shard_tensor(t: torch.Tensor, pl: Placement, rank: int, n: int) -> torch.Tensor:
    """Rank ``rank``'s part of the full tensor ``t``."""
    if pl.kind == "replicated" or n == 1:
        return t
    if pl.glu:
        e = t.shape[0] // 2
        c = e // n
        return torch.cat([t.narrow(0, rank * c, c), t.narrow(0, e + rank * c, c)], dim=0)
    c = t.shape[pl.dim] // n
    return t.narrow(pl.dim, rank * c, c)


def unshard_tensor(parts: list, pl: Placement) -> torch.Tensor:
    """The full tensor from the ranks' parts, in rank order."""
    if pl.kind == "replicated" or len(parts) == 1:
        return parts[0]
    if pl.glu:
        c = parts[0].shape[0] // 2
        return torch.cat([p[:c] for p in parts] + [p[c:] for p in parts], dim=0)
    return torch.cat(parts, dim=pl.dim)


def shard_state_dict(full_sd: dict, model_rank: int, n: int) -> dict:
    """Rank ``model_rank``'s shards of a full state dict (parameters and
    buffers by the port's names), over ``n`` ranks."""
    return {k: shard_tensor(v, placement_of(k, tuple(v.shape), n), model_rank, n)
            if torch.is_tensor(v) else v for k, v in full_sd.items()}


class ParamShard(NamedTuple):
    """What a sharded parameter keeps of its split (``param.tp_shard``)."""

    placement: Placement
    rank: int
    size: int


def local(p: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """This rank's part of ``full``, a tensor shaped like the whole of the
    parameter ``p`` (itself when ``p`` is not sharded)."""
    s = getattr(p, "tp_shard", None)
    return full if s is None else shard_tensor(full, s.placement, s.rank, s.size)


def full_shape(p: torch.Tensor) -> tuple:
    """The shape of the whole of parameter ``p``."""
    s = getattr(p, "tp_shard", None)
    shape = list(p.shape)
    if s is not None and s.placement.kind != "replicated":
        shape[s.placement.dim] *= s.size
    return tuple(shape)


def is_sharded(model: nn.Module) -> bool:
    return getattr(model, "tp_region", None) is not None


def gather_tensors(model: nn.Module, tensors: dict) -> dict:
    """The full tensors of a sharded ``model``'s tensors by name (its
    parameters, buffers or gradients, in the same order on every rank of
    the model group: a collective)."""
    if not is_sharded(model):
        return dict(tensors)
    reg, placement = model.tp_region, model.tp_placement
    out = {}
    for name, t in tensors.items():
        pl = placement.get(name, REPLICATED)
        if pl.kind == "replicated" or not torch.is_tensor(t):
            out[name] = t
            continue
        parts = all_gather(t.detach()[None], reg, 0).unbind(0)
        out[name] = unshard_tensor(list(parts), pl)
    return out


def gather_state_dict(model: nn.Module) -> dict:
    """The full state dict of a (sharded) model, on every rank of its model
    group: a collective."""
    return gather_tensors(model, model.state_dict())


def localize_state_dict(model: nn.Module, full_sd: dict) -> dict:
    """``full_sd`` cut to ``model``'s shards (itself for a whole model)."""
    if not is_sharded(model):
        return full_sd
    reg = model.tp_region
    return shard_state_dict(full_sd, reg.rank, reg.size)


def _state_by_name(optimizer, model):
    """(optimizer.state_dict() with its per-parameter dicts copied: torch
    hands out the optimizer's own, {state index: parameter name})."""
    names = {id(p): n for n, p in model.named_parameters()}
    order = [names[id(p)] for g in optimizer.param_groups for p in g["params"]]
    sd = optimizer.state_dict()
    return {**sd, "state": {k: dict(v) for k, v in sd["state"].items()}}, dict(enumerate(order))


def gather_optimizer_state(optimizer, model: nn.Module) -> dict:
    """The optimizer's state dict with every per-parameter tensor of a
    sharded model's sharded parameters gathered whole: a collective."""
    sd, names = _state_by_name(optimizer, model)
    if not is_sharded(model):
        return sd
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    for idx in sorted(sd["state"]):
        name = names[idx]
        for key, t in sorted(sd["state"][idx].items()):
            if torch.is_tensor(t) and tuple(t.shape) == shapes[name]:
                sd["state"][idx][key] = gather_tensors(model, {name: t})[name]
    return sd


def localize_optimizer_state(sd: dict, optimizer, model: nn.Module) -> dict:
    """A full optimizer state dict cut to ``model``'s shards."""
    if not is_sharded(model):
        return sd
    _, names = _state_by_name(optimizer, model)
    params = dict(model.named_parameters())
    state = {}
    for idx, entries in sd["state"].items():
        p = params[names[int(idx)]]
        state[idx] = {k: local(p, t) if torch.is_tensor(t) and tuple(t.shape) == full_shape(p)
                      else t for k, t in entries.items()}
    return {**sd, "state": state}


def sync_replicated_grads(model: nn.Module) -> None:
    """Average the gradients of a sharded model's replicated parameters
    over its model group, in one all-reduce. Each rank computes them from
    the same replicated activations, but on the card the atomics of some
    backward kernels (an index_add's, cuDNN's weight gradients) may sum
    them in another order on each rank; averaging keeps the replicas bit
    for bit equal (where the ranks agree, the mean is their gradient)."""
    if not is_sharded(model):
        return
    grads = [p.grad for p in model.parameters()
             if getattr(p, "tp_shard", None) is None and p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    flat = all_reduce(flat, model.tp_region).div_(model.tp_region.size)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def grad_norm(model: nn.Module, grads: list) -> torch.Tensor:
    """The global L2 norm of ``model``'s parameter gradients ``grads`` (in
    ``model.parameters()`` order), from their squares summed in float64 (an
    fp32 sum over a tensor of millions of entries loses ~1e-4 of it): a
    sharded parameter's squares summed over the model group, a replicated
    one's counted once, so it equals the one-process norm."""
    def squares(gs):
        return (torch.stack([g.double().square().sum() for g in gs]).sum() if gs
                else torch.zeros((), dtype=torch.float64, device=grads[0].device))

    if not is_sharded(model):
        return squares(grads).sqrt().to(torch.float32)
    split = [getattr(p, "tp_shard", None) is not None for p in model.parameters()]
    sq = all_reduce(squares([g for s, g in zip(split, grads) if s]), model.tp_region)
    return (sq + squares([g for s, g in zip(split, grads) if not s])).sqrt().to(torch.float32)


# ---------------------------------------------------------------- the model


def shard_model_(model: nn.Module, reg: Optional[Region] = None) -> nn.Module:
    """Take ``model`` (built whole, the same on every rank) to this rank's
    shards over the model group ``reg`` (by default the grid's), in place,
    and set its layers' parallel forms. A layer whose placement is
    replicated (a width ``reg.size`` does not divide) keeps its whole form.
    Returns the model."""
    from efficientconformer_torch.models.attentions import MultiHeadSelfAttention
    from efficientconformer_torch.models.joint_networks import JointNetwork
    from efficientconformer_torch.models.layers import Dropout
    from efficientconformer_torch.models.modules import ConvolutionModule, FeedForwardModule

    reg = region() if reg is None else reg
    if reg.size == 1 or is_sharded(model):
        return model
    n = reg.size
    placement = param_placement(model, n)

    def sharded(layer, kind):
        pl = placement.get(f"{names[layer]}.weight", REPLICATED)
        return pl.kind == kind

    names = {m: name for name, m in model.named_modules()}
    for name, m in model.named_modules():
        if isinstance(m, FeedForwardModule):
            linears = [x for x in m.layers if isinstance(x, nn.Linear)]
            if not sharded(linears[0], "column"):
                continue
            m.tp = linears[0].tp = linears[1].tp = reg
            linears[0].tp_mode, linears[1].tp_mode = "column", "row"
            # the inner dropout draws the whole width's mask and keeps its slice
            for x in m.layers[2:-1]:
                if isinstance(x, Dropout):
                    x.tp = reg
        elif isinstance(m, ConvolutionModule):
            pw1, dw, bn, pw2 = m.layers[2], m.layers[4], m.layers[5], m.layers[7]
            if not sharded(pw1, "column"):
                continue
            m.tp = reg
            pw1.tp_mode, pw2.tp_mode = "column", "row"
            pw1.tp = pw2.tp = reg
            dw.groups = dw.in_channels = dw.out_channels = dw.out_channels // n
            bn.num_features //= n
        elif isinstance(m, MultiHeadSelfAttention):
            m.shard_(reg, placement, name)
        elif isinstance(m, JointNetwork):
            for lin in (m.linear_encoder, m.linear_decoder):
                if lin is not None and sharded(lin, "column"):
                    lin.tp, lin.tp_mode = reg, "gather"
            if sharded(m.linear_joint, "column"):
                m.linear_joint.tp, m.linear_joint.tp_mode = reg, "column"
                m.tp = reg
        elif hasattr(m, "fc") and isinstance(m.fc, nn.Linear) and name == "":
            if sharded(m.fc, "column"):
                m.fc.tp, m.fc.tp_mode = reg, "gather"

    with torch.no_grad():
        for pname, p in model.named_parameters():
            pl = placement[pname]
            if pl.kind != "replicated":
                p.data = shard_tensor(p.data, pl, reg.rank, n).contiguous().clone()
                p.tp_shard = ParamShard(pl, reg.rank, n)
        for mod in model.modules():
            for bname, b in list(mod._buffers.items()):
                full = f"{names[mod]}.{bname}" if names[mod] else bname
                pl = placement.get(full, REPLICATED)
                if b is not None and pl.kind != "replicated":
                    mod._buffers[bname] = shard_tensor(b, pl, reg.rank, n).contiguous().clone()
    model.tp_placement = placement
    model.tp_region = reg
    return model
