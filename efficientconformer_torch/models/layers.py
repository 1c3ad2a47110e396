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
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


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
    weight of every layer of ``module`` built with a ``vn_std``."""
    for m in module.modules():
        if isinstance(m, VariationalNoise) and m.vn_std:
            m.vn_noise = {name: torch.randn(getattr(m, name).shape, generator=generator,
                                            device=getattr(m, name).device)
                          for name in m.vn_weights()}


def clear_variational_noise_(module: nn.Module) -> None:
    for m in module.modules():
        if isinstance(m, VariationalNoise):
            m.vn_noise = None


class Linear(VariationalNoise, nn.Linear):
    def __init__(self, in_features: int, out_features: int, vn_std: Optional[float] = None):
        super().__init__(in_features, out_features)
        self.vn_std = vn_std

    def forward(self, x):
        return F.linear(x, _cast(self.noisy("weight"), x), _cast(self.bias, x))


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


class Conv1d(VariationalNoise, nn.Conv1d):
    """Conv1d over (B, C, T) with symmetric 'same' padding (k-1)//2 unless
    another padding is given: an int, or "causal", k-1 zeros on the left
    and none on the right (layers.py:127-133), with any stride; variational
    noise on the weight with ``vn_std``."""

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
        return self._conv_forward(x, _cast(self.noisy("weight"), x), _cast(self.bias, x))


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


class _BatchNorm:
    """Batch norm (eps 1e-5) in fp32, output in the input dtype, with the JAX
    package's (flax) semantics. Eval: the running statistics. Training: the
    batch mean and *biased* variance over every axis but the features,
    padded frames included, and the running statistics updated as
    0.9 * old + 0.1 * batch with that biased variance (flax BatchNorm,
    momentum 0.9), except inside ``frozen_batch_stats``. torch's own
    training-mode update would use the unbiased variance for running_var,
    which differs at small batches."""

    MOMENTUM = 0.9

    def forward(self, x):
        x32 = x.to(torch.float32)
        if not self.training:
            y = F.batch_norm(x32, self.running_mean, self.running_var, self.weight, self.bias,
                             False, 0.0, self.eps)
            return y.to(x.dtype)
        y = F.batch_norm(x32, None, None, self.weight, self.bias, True, 0.0, self.eps)
        if getattr(_FROZEN_STATS, "on", False):
            return y.to(x.dtype)
        with torch.no_grad():
            dims = [0] + list(range(2, x.dim()))
            var, mean = torch.var_mean(x32, dim=dims, correction=0)
            self.running_mean.lerp_(mean, 1.0 - self.MOMENTUM)
            self.running_var.lerp_(var, 1.0 - self.MOMENTUM)
        return y.to(x.dtype)


class BatchNorm1d(_BatchNorm, nn.BatchNorm1d):
    pass


class BatchNorm2d(_BatchNorm, nn.BatchNorm2d):
    pass


class Dropout(nn.Module):
    """Dropout whose keep-mask is drawn from an explicit ``torch.Generator``
    (on the tensor's device), kept values scaled by 1/(1-p), as flax's
    Dropout. The identity in eval mode or when p = 0."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x, generator=None):
        if not self.training or self.p == 0.0:
            return x
        if generator is None:
            raise ValueError("Dropout in training mode needs a torch.Generator")
        keep = torch.empty_like(x).bernoulli_(1.0 - self.p, generator=generator)
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
