"""Primitive layers.

Counterpart of efficientconformer_tpu/models/layers.py. Parameters are kept
in fp32 and cast to the activation dtype at each use, as the JAX package
does under its bf16 policy. LayerNorm and BatchNorm compute in fp32 and cast
their output back to the input dtype.

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


class _EvalBatchNorm:
    """Batch norm from the running statistics (eps 1e-5) in fp32, output in
    the input dtype. Batch statistics come with the training slice; the
    encoder refuses training mode until then."""

    def forward(self, x):
        y = F.batch_norm(x.to(torch.float32), self.running_mean, self.running_var,
                         self.weight, self.bias, False, 0.0, self.eps)
        return y.to(x.dtype)


class BatchNorm1d(_EvalBatchNorm, nn.BatchNorm1d):
    pass


class BatchNorm2d(_EvalBatchNorm, nn.BatchNorm2d):
    pass


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
