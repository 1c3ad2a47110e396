"""Conformer building modules.

Counterpart of efficientconformer_tpu/models/modules.py. Activations are
(B, T, D) between modules. The subsampling convolutions (Conv1d, Conv2d,
Conv2dPool, VGG, with batch, layer or no norm and relu, swish or no
activation) and the convolution module run in torch's channels-first layout
internally, as the original PyTorch repo does, so that their parameters keep
its names and layouts. With ``vn_std`` the feed-forward, attention and
convolution modules carry variational noise on their weights, as the JAX
modules' (the Conformer decoder's blocks).
In training mode BatchNorm uses batch statistics (models/layers.py) and
dropout and SpecAugment draw from the generator passed to ``forward``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from efficientconformer_torch.models.attentions import MultiHeadSelfAttention
from efficientconformer_torch.models.layers import (
    BatchNorm1d,
    BatchNorm2d,
    ChannelLayerNorm,
    Conv1d,
    Conv2d,
    Dropout,
    Glu,
    LayerNorm,
    Linear,
    Swish,
    Transpose,
)
from efficientconformer_torch.ops import specaugment
from efficientconformer_torch.ops.audio import log_mel_spectrogram


def run_layers(layers: nn.Sequential, x, generator):
    """Apply ``layers`` in order, handing the generator to the dropouts."""
    for layer in layers:
        x = layer(x, generator) if isinstance(layer, Dropout) else layer(x)
    return x


class AudioPreprocessing(nn.Module):
    """Log-mel frontend (ops/audio.py); stateless, fp32."""

    def __init__(self, sample_rate=16000, n_fft=512, win_length_ms=25, hop_length_ms=10,
                 n_mels=80, normalize=False, mean=0.0, std=1.0):
        super().__init__()
        self.kwargs = dict(sample_rate=sample_rate, n_fft=n_fft, win_length_ms=win_length_ms,
                           hop_length_ms=hop_length_ms, n_mels=n_mels, normalize=normalize,
                           mean=mean, std=std)

    def forward(self, x, x_len):
        return log_mel_spectrogram(x, x_len, **self.kwargs)


class SpecAugment(nn.Module):
    """SpecAugment (ops/specaugment.py) in training mode when enabled; the
    identity otherwise."""

    def __init__(self, spec_augment: bool, mF: int, F: int, mT: int, pS: float):
        super().__init__()
        self.enabled = spec_augment
        self.kwargs = dict(mF=mF, F=F, mT=mT, pS=pS)

    def forward(self, x, x_len, generator=None):
        if not (self.enabled and self.training):
            return x
        if generator is None:
            raise ValueError("SpecAugment in training mode needs a torch.Generator")
        return specaugment.spec_augment(x, x_len, generator, **self.kwargs)


def _act(name: str) -> nn.Module:
    """The subsampling and feed-forward activations (modules.py:32-39)."""
    if name == "relu":
        return nn.ReLU()
    if name == "swish":
        return Swish()
    if name == "none":
        return nn.Identity()
    raise ValueError(f"unknown activation {name}")


def _norm(name: str, channels: int, dims: int) -> nn.Module:
    """A subsampling norm over the channels of a (B, C, ...) layout: batch
    norm, layer norm over the channels, or none (any other name), as the
    JAX modules' (modules.py:108-111)."""
    if name == "batch":
        return (BatchNorm1d if dims == 1 else BatchNorm2d)(channels)
    if name == "layer":
        return ChannelLayerNorm(channels)
    return nn.Identity()


def _flatten(x):
    """(B, C, mel, T) -> (B, T, C*mel), channel-major."""
    b, c, m, t = x.shape
    return x.reshape(b, c * m, t).transpose(1, 2)


class Conv1dSubsampling(nn.Module):
    """Stride-2 Conv1d -> norm -> activation layers over (B, mel, time),
    'same' padding (k-1)//2, lengths (l-1)//2 + 1 per layer (modules.py
    :91-115). Returns (B, T', filters[-1])."""

    def __init__(self, num_layers: int, filters: Sequence[int], kernel_size: int,
                 norm: str, act: str, in_dim: int):
        super().__init__()
        chans = [in_dim] + list(filters)
        self.layers = nn.ModuleList(
            nn.Sequential(Conv1d(chans[i], chans[i + 1], kernel_size, stride=2),
                          _norm(norm, chans[i + 1], 1), _act(act))
            for i in range(num_layers))

    def out_features(self, n_mels: int) -> int:
        return self.layers[-1][0].out_channels

    def forward(self, x, x_len):
        x = x.transpose(1, 2)                             # (B, mel, T)
        for layer in self.layers:
            x = layer(x)
            if x_len is not None:
                x_len = (x_len - 1) // 2 + 1
        return x.transpose(1, 2), x_len


class Conv2dSubsampling(nn.Module):
    """Stack of stride-2 Conv2d -> norm -> activation layers over
    (B, C, mel, time), padding (k-1)//2 so lengths go to (l-1)//2 + 1
    (modules.py:118-151). Returns (B, T', C*mel') features flattened
    channel-major."""

    def __init__(self, num_layers: int, filters: Sequence[int], kernel_size: int,
                 norm: str, act: str, in_dim: Optional[int] = None):
        super().__init__()
        p = (kernel_size - 1) // 2
        chans = [1] + list(filters)
        self.layers = nn.ModuleList(
            nn.Sequential(Conv2d(chans[i], chans[i + 1], kernel_size, stride=2, padding=p),
                          _norm(norm, chans[i + 1], 2), _act(act))
            for i in range(num_layers)
        )

    def out_features(self, n_mels: int) -> int:
        for _ in self.layers:
            n_mels = (n_mels - 1) // 2 + 1
        return self.layers[-1][0].out_channels * n_mels

    def forward(self, x, x_len):
        x = x.transpose(1, 2)[:, None]                    # (B, 1, mel, T)
        for layer in self.layers:
            x = layer(x)
            if x_len is not None:
                x_len = (x_len - 1) // 2 + 1
        return _flatten(x), x_len


class Conv2dPoolSubsampling(Conv2dSubsampling):
    """Conv2d (stride 1, padding (k-1)//2) -> 3x3 max-pool with stride 2
    and padding 1 (padded with -inf, as the JAX package's
    ``_max_pool_2d``) -> norm -> activation per layer (modules.py:154-196):
    lengths (l-1)//2 + 1 per layer, as the strided convs'. The pool has no
    parameters; the layers hold (conv, norm, activation) at the indices of
    Conv2dSubsampling's, so their weights map alike."""

    def __init__(self, num_layers: int, filters: Sequence[int], kernel_size: int,
                 norm: str, act: str, in_dim: Optional[int] = None):
        super().__init__(num_layers, filters, kernel_size, norm, act)
        for layer in self.layers:
            layer[0].stride = (1, 1)

    def forward(self, x, x_len):
        x = x.transpose(1, 2)[:, None]
        for conv, norm, act in self.layers:
            x = act(norm(F.max_pool2d(conv(x), 3, stride=2, padding=1)))
            if x_len is not None:
                x_len = (x_len - 1) // 2 + 1
        return _flatten(x), x_len


class VGGSubsampling(nn.Module):
    """Per stage two Conv2d (stride 1, padding (k-1)//2) -> norm ->
    activation, then a 2x2 max-pool (modules.py:199-231): lengths l // 2
    per stage, not the conv formula. The original repo's layer indices:
    conv 0 and 3, norm 1 and 4, activation 2 and 5, pool 6."""

    def __init__(self, num_layers: int, filters: Sequence[int], kernel_size: int,
                 norm: str, act: str, in_dim: Optional[int] = None):
        super().__init__()
        p = (kernel_size - 1) // 2
        chans = [1] + list(filters)
        self.layers = nn.ModuleList(
            nn.Sequential(
                Conv2d(chans[i], chans[i + 1], kernel_size, padding=p),
                _norm(norm, chans[i + 1], 2), _act(act),
                Conv2d(chans[i + 1], chans[i + 1], kernel_size, padding=p),
                _norm(norm, chans[i + 1], 2), _act(act),
                nn.MaxPool2d(2))
            for i in range(num_layers))

    def out_features(self, n_mels: int) -> int:
        return self.layers[-1][0].out_channels * (n_mels >> len(self.layers))

    def forward(self, x, x_len):
        x = x.transpose(1, 2)[:, None]
        for layer in self.layers:
            x = layer(x)
            if x_len is not None:
                x_len = x_len // 2
        return _flatten(x), x_len


SUBSAMPLING = {
    "Conv1d": Conv1dSubsampling,
    "Conv2d": Conv2dSubsampling,
    "Conv2dPool": Conv2dPoolSubsampling,
    "VGG": VGGSubsampling,
}


class FeedForwardModule(nn.Module):
    """LN -> Linear(ffn) -> act -> [drop] -> Linear(dim) -> drop: swish with
    the inner dropout in a Conformer block, relu without it in a
    Transformer block (modules.py:247-267)."""

    def __init__(self, dim_model: int, dim_ffn: int, dropout: float, act: str = "swish",
                 inner_dropout: bool = True, vn_std: Optional[float] = None):
        super().__init__()
        inner = [Dropout(dropout)] if inner_dropout else []
        self.layers = nn.Sequential(
            LayerNorm(dim_model),
            Linear(dim_model, dim_ffn, vn_std),
            _act(act),
            *inner,
            Linear(dim_ffn, dim_model, vn_std),
            Dropout(dropout),
        )

    def forward(self, x, generator=None):
        return run_layers(self.layers, x, generator)


class MultiHeadSelfAttentionModule(nn.Module):
    """Pre-LN -> self-attention -> dropout. The combinations the JAX module
    asserts against (modules.py:286-297) raise ValueError."""

    def __init__(self, dim_model: int, num_heads: int, dropout: float,
                 relative_pos_enc: bool = False, causal: bool = False, group_size: int = 1,
                 kernel_size=None, stride: int = 1, linear_att: bool = False,
                 vn_std: Optional[float] = None):
        super().__init__()
        if group_size > 1 and kernel_size is not None:
            raise ValueError("Local grouped attention not implemented")
        if group_size > 1 and stride > 1:
            raise ValueError("Strided grouped attention not implemented")
        if linear_att and relative_pos_enc:
            raise ValueError("Linear attention requires absolute positional encodings")
        self.norm = LayerNorm(dim_model)
        self.mhsa = MultiHeadSelfAttention(
            dim_model, num_heads, causal=causal, group_size=group_size,
            kernel_size=kernel_size, stride=stride, linear_att=linear_att,
            relative_pos_enc=relative_pos_enc, vn_std=vn_std,
        )
        self.dropout = Dropout(dropout)

    def forward(self, x, mask=None, generator=None):
        return self.dropout(self.mhsa(self.norm(x), mask), generator)


class ConvolutionModule(nn.Module):
    """LN -> pointwise(2E) -> GLU -> depthwise(k, stride) -> BN -> swish ->
    pointwise(E) -> drop. The first pointwise conv carries the width change
    D -> E of an expand block, the depthwise conv the stage stride; it pads
    causally in a causal encoder (modules.py:313-346), "same" otherwise."""

    def __init__(self, dim_model: int, dim_expand: int, kernel_size: int, dropout: float,
                 stride: int = 1, causal: bool = False, vn_std: Optional[float] = None):
        super().__init__()
        self.layers = nn.Sequential(
            LayerNorm(dim_model),
            Transpose(1, 2),
            Conv1d(dim_model, 2 * dim_expand, 1, vn_std=vn_std),
            Glu(dim=1),
            Conv1d(dim_expand, dim_expand, kernel_size, stride=stride, groups=dim_expand,
                   padding="causal" if causal else None, vn_std=vn_std),
            BatchNorm1d(dim_expand),
            Swish(),
            Conv1d(dim_expand, dim_expand, 1, vn_std=vn_std),
            Dropout(dropout),
            Transpose(1, 2),
        )

    def forward(self, x, generator=None):
        return run_layers(self.layers, x, generator)

    def step(self, x, state):
        """One frame x (B, 1, D) of a causal module with no stride, in eval
        mode, given the depthwise conv's last K-1 inputs ``state`` (B, E,
        K-1): (the frame's output (B, 1, E), the state shifted by its
        input)."""
        layers = self.layers
        g = run_layers(layers[:4], x, None)            # LN, pointwise, GLU: (B, E, 1)
        window = torch.cat([state.to(g.dtype), g], dim=2)
        y = layers[4](window)[..., -1:]                # the causal conv's output at this frame
        return run_layers(layers[5:], y, None), window[..., 1:]
