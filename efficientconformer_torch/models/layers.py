"""Primitive layers.

Counterpart of efficientconformer_tpu/models/layers.py. Parameters are kept
in fp32 and cast to the activation dtype at each use, as the JAX package
does under its bf16 policy. LayerNorm and BatchNorm compute in fp32 and cast
their output back to the input dtype. Dropout draws from an explicit
generator.

Variational noise (the JAX package's ``vn_std``, layers.py:40-46): a Linear,
Conv1d, Embedding or LSTM built with ``vn_std`` uses its weights as
w + vn_std * N(0, 1) while a draw is set on it. ``draw_variational_noise_``
sets one draw from an explicit generator on every such layer of a module,
``clear_variational_noise_`` removes it; the trainer draws once per optimizer
step, so every microbatch of the step sees the same noise. Biases get none.

The layers subclass torch's own, so parameter names and layouts are the
original PyTorch repo's (``weight`` (out, in[, k...]), ``bias``,
``running_mean``...): see utils/weights.py.

Under a process group of more than one data rank (parallel/mesh.py),
BatchNorm in training mode normalises with the statistics of the global
batch, as the JAX package's data mesh does (mesh.py:7-9): each rank's
per-channel count, mean and variance are gathered in fp32 by an all-reduce
over the data group that autograd differentiates, so the backward sums over
the data ranks too, and combined. The ranks of one model group hold other
channels of the convolution module's BatchNorm under tensor parallelism,
so the table never spans a model group. Under sequence parallelism an input
split along time (``sharded``) takes its statistics over the data x seq
group instead, each rank counting its own frames.

Tensor parallelism (parallel/tensor.py) gives Linear and Conv1d a parallel
form, ``tp_mode``: "column" (this rank's output features; the input has
entered the region), "row" (this rank's input features: the partial
products summed over the model group, then the bias) or "gather" (a
replicated input, this rank's output features, gathered whole). A sharded
weight's variational noise is drawn at the whole weight's shape and cut to
the rank's part, so the noise is the one-process draw; a Dropout with
``tp`` set (inside a parallel region) draws the whole width's mask and keeps
its slice likewise.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from efficientconformer_torch.parallel import mesh
from efficientconformer_torch.parallel import tensor as tp_ops
from efficientconformer_torch.parallel.mesh import all_reduce_sum


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def glu(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    a, b = x.chunk(2, dim=dim)
    return a * torch.sigmoid(b)


class Swish(nn.Module):
    def forward(self, x):
        return swish(x)


class Glu(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        return glu(x, self.dim)


class Transpose(nn.Module):
    def __init__(self, dim0: int, dim1: int):
        super().__init__()
        self.dims = (dim0, dim1)

    def forward(self, x):
        return x.transpose(*self.dims)


def _cast(p, x):
    return None if p is None else p.to(x.dtype)


class VariationalNoise:
    """Mixin of the layers that take variational noise on the weights named
    in ``vn_weights``."""

    vn_std: Optional[float] = None
    vn_noise: Optional[dict] = None     # weight name -> N(0, 1) draw, while set

    def vn_weights(self) -> tuple:
        return ("weight",)

    def noisy(self, name: str) -> torch.Tensor:
        w = getattr(self, name)
        if self.vn_noise is None:
            return w
        return w + self.vn_std * self.vn_noise[name]


def draw_variational_noise_(module: nn.Module, generator: torch.Generator) -> None:
    """One N(0, 1) draw from ``generator`` (on the weights' device) for every
    weight of every layer of ``module`` built with a ``vn_std``; a sharded
    weight's at the whole weight's shape, cut to this rank's part."""
    for m in module.modules():
        if isinstance(m, VariationalNoise) and m.vn_std:
            m.vn_noise = {}
            for name in m.vn_weights():
                w = getattr(m, name)
                m.vn_noise[name] = tp_ops.local(
                    w, torch.randn(tp_ops.full_shape(w), generator=generator, device=w.device))


def clear_variational_noise_(module: nn.Module) -> None:
    for m in module.modules():
        if isinstance(m, VariationalNoise):
            m.vn_noise = None


class Parallel:
    """Mixin of the layers with a tensor-parallel form: ``tp_mode`` None
    (whole), "column", "row" or "gather" over the model group ``tp``."""

    tp_mode: Optional[str] = None
    tp = None

    def parallel(self, x, product, bias):
        """``product(x)`` (without the bias) in this layer's parallel form,
        ``bias`` broadcast over its output."""
        mode, reg = self.tp_mode, self.tp
        if mode == "row":
            return tp_ops.reduce_from_region(product(x), reg) + bias
        if mode == "gather":
            return tp_ops.gather_features(product(tp_ops.copy_to_region(x, reg)) + bias, reg,
                                          self.feature_dim)
        return product(x) + bias


class Linear(Parallel, VariationalNoise, nn.Linear):
    feature_dim = -1

    def __init__(self, in_features: int, out_features: int, vn_std: Optional[float] = None):
        super().__init__(in_features, out_features)
        self.vn_std = vn_std

    def forward(self, x):
        w, b = _cast(self.noisy("weight"), x), _cast(self.bias, x)
        if self.tp_mode is None:
            return F.linear(x, w, b)
        return self.parallel(x, lambda y: F.linear(y, w), b)


class IdentityProjection(nn.Module):
    """The input followed by a learned projection of it to the remaining
    ``features`` - ``in_features`` features (layers.py:267-279, a ContextNet
    helper): (..., in_features) -> (..., features)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        if features <= in_features:
            raise ValueError(f"IdentityProjection to {features} features from {in_features}")
        self.linear = Linear(in_features, features - in_features)

    def forward(self, x):
        return torch.cat([x, self.linear(x)], dim=-1)


class Embedding(VariationalNoise, nn.Embedding):
    """Token embedding whose id 0 embeds to zeros, by a mask on the output
    (layers.py:188-196): the table's row 0 is a drawn row like any other, so
    ``padding_idx`` (which pins the row at zero) would not give the JAX
    package's output from the same table."""

    def __init__(self, num_embeddings: int, features: int, vn_std: Optional[float] = None):
        super().__init__(num_embeddings, features)
        self.vn_std = vn_std

    def forward(self, ids):
        y = F.embedding(ids, self.noisy("weight"))
        return y * (ids != 0)[..., None].to(y.dtype)


class LSTM(VariationalNoise, nn.LSTM):
    """Unidirectional multi-layer LSTM over (B, T, D), torch gate order
    (i, f, g, o), two biases per layer (layers.py:199-264). The weights are
    cast to the activation dtype at each call, and carry variational noise
    on w_ih and w_hh. The carry (h, c) is (num_layers, B, H) each, in the
    activation dtype.

    Computed by ``torch.lstm``, the function under ``nn.LSTM``, which on
    the card is cuDNN's LSTM (the JAX package's ``lax.scan`` is no Pallas
    kernel, so this is no kernel of the port). In fp32 its result is the
    scan's up to the order of the sums. In bf16 cuDNN takes bf16 inputs,
    weights and states and computes the gate sums and the cell update in
    fp32 (its kernels are elemWiseRNNcell<bf16, bf16, float> on an H100),
    where the JAX package's scan rounds the gate sums to bf16 as well. The
    weights passed per call are not one flat buffer, so cuDNN copies them
    into one at each call (and warns once)."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 vn_std: Optional[float] = None):
        super().__init__(input_size, hidden_size, num_layers, batch_first=True)
        self.vn_std = vn_std

    def vn_weights(self) -> tuple:
        return tuple(f"weight_{w}_l{i}" for i in range(self.num_layers) for w in ("ih", "hh"))

    def init_carry(self, batch: int, device, dtype=torch.float32):
        shape = (self.num_layers, batch, self.hidden_size)
        return (torch.zeros(shape, device=device, dtype=dtype),
                torch.zeros(shape, device=device, dtype=dtype))

    def forward(self, x, carry=None):
        """x (B, T, D) -> (out (B, T, H), (h, c))."""
        if carry is None:
            carry = self.init_carry(x.shape[0], x.device, x.dtype)
        weights = []
        for i in range(self.num_layers):
            weights += [self.noisy(f"weight_ih_l{i}"), self.noisy(f"weight_hh_l{i}"),
                        getattr(self, f"bias_ih_l{i}"), getattr(self, f"bias_hh_l{i}")]
        weights = [w.to(x.dtype) for w in weights]
        h, c = (s.to(x.dtype) for s in carry)
        out, h, c = torch.lstm(x, (h, c), weights, True, self.num_layers, 0.0, self.training,
                               False, True)
        return out, (h, c)


class Conv1d(Parallel, VariationalNoise, nn.Conv1d):
    """Conv1d over (B, C, T) with symmetric 'same' padding (k-1)//2 unless
    another padding is given: an int, or "causal", k-1 zeros on the left
    and none on the right (layers.py:127-133), with any stride; variational
    noise on the weight with ``vn_std``. A pointwise conv has the parallel
    forms of a Linear over its channels."""

    feature_dim = 1

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, groups=1,
                 padding=None, vn_std: Optional[float] = None):
        causal = padding == "causal"
        if padding is None:
            padding = (kernel_size - 1) // 2
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=0 if causal else padding, groups=groups)
        self.causal = causal
        self.vn_std = vn_std

    def forward(self, x):
        if self.causal:
            x = F.pad(x, (self.kernel_size[0] - 1, 0))
        w, b = _cast(self.noisy("weight"), x), _cast(self.bias, x)
        if self.tp_mode is None:
            return self._conv_forward(x, w, b)
        return self.parallel(x, lambda y: self._conv_forward(y, w, None), b[:, None])


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(x, _cast(self.weight, x), _cast(self.bias, x))


class LayerNorm(nn.LayerNorm):
    """LayerNorm with eps 1e-6, computed in fp32, output in the input dtype."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x):
        y = F.layer_norm(x.to(torch.float32), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.to(x.dtype)


class ChannelLayerNorm(LayerNorm):
    """LayerNorm over the channels of a (B, C, ...) layout (the subsamplings'
    "layer" norm, which the JAX package takes over the channels of its
    channels-last layout)."""

    def forward(self, x):
        return super().forward(x.movedim(1, -1)).movedim(-1, 1)


_FROZEN_STATS = threading.local()


@contextlib.contextmanager
def frozen_batch_stats():
    """Inside it, BatchNorm in training mode normalises with the batch
    statistics as always but leaves its running statistics alone: the
    recompute of a block under remat (models/encoders.py), whose forward
    updated them already. Per thread: the backward, and so the recompute,
    may run on another thread than the forward."""
    before = getattr(_FROZEN_STATS, "on", False)
    _FROZEN_STATS.on = True
    try:
        yield
    finally:
        _FROZEN_STATS.on = before


_LOCAL_STATS = threading.local()


@contextlib.contextmanager
def local_batch_stats():
    """Inside it, BatchNorm in training mode takes the statistics of this
    process's batch alone, with no collective, under a process group too:
    the BN refresh, which every rank runs over the same batches
    (runtime.bn_refresh)."""
    before = getattr(_LOCAL_STATS, "on", False)
    _LOCAL_STATS.on = True
    try:
        yield
    finally:
        _LOCAL_STATS.on = before


def _stats_group(sharded: bool):
    """(group, this rank's index, size) over which BatchNorm's training
    statistics are taken, or None for this process's batch alone: the data
    group, or under sequence parallelism, for an input split along time,
    the data x seq group (mesh.replica_group)."""
    if not dist.is_initialized() or getattr(_LOCAL_STATS, "on", False):
        return None
    g = mesh.grid()
    if sharded and g.seq_size > 1:
        return (g.replica_group, g.replica_rank, g.replica_size)
    return (g.data_group, g.data_rank, g.data_size) if g.data_size > 1 else None


class _BatchNorm:
    """Batch norm (eps 1e-5) in fp32, output in the input dtype, with the JAX
    package's (flax) semantics. Eval: the running statistics. Training: the
    batch mean and *biased* variance over every axis but the features,
    padded frames included, and the running statistics updated as
    0.9 * old + 0.1 * batch with that biased variance (flax BatchNorm,
    momentum 0.9), except inside ``frozen_batch_stats``. torch's own
    training-mode update would use the unbiased variance for running_var,
    which differs at small batches. Under a process group of more than one
    rank the batch is the global one (``_synced_forward``): over the data
    ranks, or, with ``sharded`` (an input split along time under sequence
    parallelism), over the data x seq ranks."""

    MOMENTUM = 0.9

    def forward(self, x, sharded: bool = False):
        x32 = x.to(torch.float32)
        if not self.training:
            y = F.batch_norm(x32, self.running_mean, self.running_var, self.weight, self.bias,
                             False, 0.0, self.eps)
            return y.to(x.dtype)
        group = _stats_group(sharded)
        if group is not None:
            return self._synced_forward(x32, *group).to(x.dtype)
        y = F.batch_norm(x32, None, None, self.weight, self.bias, True, 0.0, self.eps)
        if getattr(_FROZEN_STATS, "on", False):
            return y.to(x.dtype)
        with torch.no_grad():
            dims = [0] + list(range(2, x.dim()))
            var, mean = torch.var_mean(x32, dim=dims, correction=0)
            self._update_running(mean, var)
        return y.to(x.dtype)

    def _update_running(self, mean, var):
        self.running_mean.lerp_(mean, 1.0 - self.MOMENTUM)
        self.running_var.lerp_(var, 1.0 - self.MOMENTUM)

    def _synced_forward(self, x32, group, rank, world):
        """Training mode over the global batch of ``group`` (``world``
        ranks, this one ``rank``): each rank's count, mean and biased
        variance per channel (two passes over its rows), gathered by one fp32
        all-reduce of a (ranks, 2C + 1) table in which each rank fills its
        row, then combined (the counts differ where time splits unevenly):
        the mean of the means, weighted by
        the counts, and the weighted mean of each rank's variance plus its
        mean's squared distance from the global mean (Chan et al.). The sum
        of squares less the squared sum (flax's ``_compute_stats``) would
        lose digits wherever a channel's mean is large beside its spread.
        Every rank combines the same table in the same order, so the running
        statistics stay equal across ranks."""
        c = x32.shape[1]
        dims = [0] + list(range(2, x32.dim()))
        var_r, mean_r = torch.var_mean(x32, dim=dims, correction=0)
        row = torch.cat([mean_r, var_r, x32.new_full((1,), x32.numel() // c)])
        table = all_reduce_sum(F.pad(row[None], (0, 0, rank, world - rank - 1)), group)
        means, variances, counts = table[:, :c], table[:, c:2 * c], table[:, 2 * c:]
        total = counts.sum()
        mean = (counts * means).sum(0) / total
        var = (counts * (variances + (means - mean).square())).sum(0) / total
        if not getattr(_FROZEN_STATS, "on", False):
            with torch.no_grad():
                self._update_running(mean, var)
        shape = (1, c) + (1,) * (x32.dim() - 2)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return (x32 - mean.view(shape)) * scale.view(shape) + self.bias.view(shape)


class BatchNorm1d(_BatchNorm, nn.BatchNorm1d):
    pass


class BatchNorm2d(_BatchNorm, nn.BatchNorm2d):
    pass


class Dropout(nn.Module):
    """Dropout whose keep-mask is drawn from an explicit ``torch.Generator``
    (on the tensor's device), kept values scaled by 1/(1-p), as flax's
    Dropout. The identity in eval mode or when p = 0. With ``tp`` set, x
    holds this rank's slice of the last dim; with a ``span``
    (parallel/sequence.Span), this rank's frames along ``time_dim``: the
    mask is drawn whole and sliced, so that it is the one-process mask."""

    tp = None

    def __init__(self, p: float, time_dim: int = 1):
        super().__init__()
        self.p = p
        self.time_dim = time_dim

    def forward(self, x, generator=None, span=None):
        if not self.training or self.p == 0.0:
            return x
        if generator is None:
            raise ValueError("Dropout in training mode needs a torch.Generator")
        if self.tp is None and span is None:
            keep = torch.empty_like(x).bernoulli_(1.0 - self.p, generator=generator)
        else:
            shape = list(x.shape)
            if self.tp is not None:
                shape[-1] *= self.tp.size
            if span is not None:
                shape[self.time_dim] = span.total
            keep = x.new_empty(shape).bernoulli_(1.0 - self.p, generator=generator)
            if self.tp is not None:
                keep = keep.narrow(-1, self.tp.rank * x.shape[-1], x.shape[-1])
            if span is not None:
                keep = keep.narrow(self.time_dim, span.start, span.length)
        return x * keep / (1.0 - self.p)


def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """torch-default init of every Linear, Conv, Embedding and LSTM in
    ``module`` from ``generator``, the distributions of models/layers.py in
    the JAX package: Linear and Conv weight and bias uniform in
    +-1/sqrt(fan_in), LSTM weights and biases uniform in +-1/sqrt(H),
    embedding tables N(0, 1)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.LSTM):
                bound = 1.0 / math.sqrt(m.hidden_size)
                for p in m.parameters():
                    p.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(generator=generator)
