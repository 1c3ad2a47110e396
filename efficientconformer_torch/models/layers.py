"""Primitive layers.

Counterpart of efficientconformer_tpu/models/layers.py. Parameters are kept
in fp32 and cast to the activation dtype at each use, as the JAX package
does under its bf16 policy. LayerNorm and BatchNorm compute in fp32 and cast
their output back to the input dtype. Dropout draws from an explicit
generator. Variational noise (the JAX package's ``vn_std``) is not ported:
models/factory.py refuses a config that sets it.

The layers subclass torch's own, so parameter names and layouts are the
original PyTorch repo's (``weight`` (out, in[, k...]), ``bias``,
``running_mean``...): see utils/weights.py.
"""

from __future__ import annotations

import math

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


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(x, _cast(self.weight, x), _cast(self.bias, x))


class Conv1d(nn.Conv1d):
    """Conv1d over (B, C, T) with symmetric 'same' padding (k-1)//2 unless
    another padding is given."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, groups=1,
                 padding=None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=(kernel_size - 1) // 2 if padding is None else padding,
                         groups=groups)

    def forward(self, x):
        return self._conv_forward(x, _cast(self.weight, x), _cast(self.bias, x))


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


class _BatchNorm:
    """Batch norm (eps 1e-5) in fp32, output in the input dtype, with the JAX
    package's (flax) semantics. Eval: the running statistics. Training: the
    batch mean and *biased* variance over every axis but the features,
    padded frames included, and the running statistics updated as
    0.9 * old + 0.1 * batch with that biased variance (flax BatchNorm,
    momentum 0.9). torch's own training-mode update would use the unbiased
    variance for running_var, which differs at small batches."""

    MOMENTUM = 0.9

    def forward(self, x):
        x32 = x.to(torch.float32)
        if not self.training:
            y = F.batch_norm(x32, self.running_mean, self.running_var, self.weight, self.bias,
                             False, 0.0, self.eps)
            return y.to(x.dtype)
        y = F.batch_norm(x32, None, None, self.weight, self.bias, True, 0.0, self.eps)
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


def init_uniform_(module: nn.Module, generator: torch.Generator) -> None:
    """torch-default init of every Linear and Conv in ``module`` from
    ``generator``: weight and bias uniform in +-1/sqrt(fan_in), the
    distribution of models/layers.py in the JAX package."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
