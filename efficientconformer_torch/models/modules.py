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
Under tensor parallelism (parallel/tensor.shard_model_, ``tp`` set) the
feed-forward and convolution modules run Megatron's pair on the rank's
columns: the LayerNorm replicated, its output entering the region, the first
linear (pointwise conv) column-parallel, then the per-feature work (the
activation and inner dropout; GLU, the depthwise conv, BatchNorm and swish)
on the rank's features, the second row-parallel with one all-reduce, and
the last dropout on the replicated output.
"""

from __future__ import annotations

import math
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
    swish,
)
from efficientconformer_torch.ops import specaugment
from efficientconformer_torch.ops.audio import log_mel_spectrogram
from efficientconformer_torch.parallel import sequence
from efficientconformer_torch.parallel import tensor as tp_ops


def run_layers(layers: nn.Sequential, x, generator, span=None):
    """Apply ``layers`` in order, handing the generator and this rank's
    frames ``span`` (sequence parallelism; None: whole) to the dropouts."""
    for layer in layers:
        x = layer(x, generator, span) if isinstance(layer, Dropout) else layer(x)
    return x


def run_parallel(layers: nn.Sequential, x, generator, reg, span=None):
    """``run_layers`` of a module whose first layer (the LayerNorm) is
    replicated and whose output enters the model group ``reg`` (None:
    whole)."""
    if reg is None:
        return run_layers(layers, x, generator, span)
    return run_layers(layers[1:], tp_ops.copy_to_region(layers[0](x), reg), generator, span)


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


def _sharded_norm(norm, y):
    """A subsampling norm of the rank's frames under sequence parallelism:
    BatchNorm over the data x seq group, each rank counting its own."""
    return norm(y, sharded=True) if isinstance(norm, (BatchNorm1d, BatchNorm2d)) else norm(y)


def _weights(conv, x):
    return conv.weight.to(x.dtype), conv.bias.to(x.dtype)


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

    def forward(self, x, x_len, seq=None):
        """(features, lengths); with a seq group ``seq`` (sequence
        parallelism) also the span of the frames returned (None: whole):
        the layers but the last run whole, and the last computes the rank's
        frames from their window of its input, as Conv2dSubsampling's."""
        x = x.transpose(1, 2)                             # (B, mel, T)
        for layer in self.layers if seq is None else self.layers[:-1]:
            x = layer(x)
            if x_len is not None:
                x_len = (x_len - 1) // 2 + 1
        if seq is None:
            return x.transpose(1, 2), x_len
        conv, norm, act = self.layers[-1]
        if x_len is not None:
            x_len = (x_len - 1) // 2 + 1
        total = (x.shape[-1] - 1) // 2 + 1
        if total % seq.size:
            return act(norm(conv(x))).transpose(1, 2), x_len, None
        span = sequence.even(total, seq)
        k, p = conv.kernel_size[0], conv.padding[0]
        lo = 2 * span.start - p
        y = F.conv1d(sequence.window(x, lo, lo + 2 * (span.length - 1) + k), *_weights(conv, x),
                     stride=2)
        return act(_sharded_norm(norm, y)).transpose(1, 2), x_len, span


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

    def forward(self, x, x_len, seq=None):
        """(features, lengths); with a seq group ``seq`` (sequence
        parallelism) also the span of the frames returned (None: whole)."""
        x = x.transpose(1, 2)[:, None]                    # (B, 1, mel, T)
        layers = self.layers if seq is None else self.layers[:-1]
        for layer in layers:
            x = layer(x)
            if x_len is not None:
                x_len = (x_len - 1) // 2 + 1
        if seq is None:
            return _flatten(x), x_len
        return self._sharded_last(x, x_len, seq)

    def _sharded_last(self, x, x_len, seq):
        """The last layer under sequence parallelism: the whole input is on
        every rank, so a rank whose output frames split evenly computes its
        own [o, o + L) from the input window [2o - p, 2(o + L - 1) - p + k)
        (zeros past the ends, as the conv's padding), with no collective;
        its BatchNorm takes data x seq statistics. Otherwise the layer runs
        whole. (features, lengths, span or None)."""
        conv, norm, act = self.layers[-1]
        if x_len is not None:
            x_len = (x_len - 1) // 2 + 1
        t_in = x.shape[-1]
        total = (t_in - 1) // 2 + 1
        if total % seq.size:
            return _flatten(act(norm(conv(x)))), x_len, None
        span = sequence.even(total, seq)
        k, p = conv.kernel_size[1], conv.padding[1]
        lo = 2 * span.start - p
        y = F.conv2d(sequence.window(x, lo, lo + 2 * (span.length - 1) + k), *_weights(conv, x),
                     stride=conv.stride, padding=(conv.padding[0], 0))
        return _flatten(act(_sharded_norm(norm, y))), x_len, span


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

    def forward(self, x, x_len, seq=None):
        """(features, lengths); with a seq group ``seq`` also the span of the
        frames returned (None: whole): the last layer's pool computes the
        rank's frames from the conv outputs under its windows (-inf past the
        ends), the conv those from their window of its input (zeros)."""
        x = x.transpose(1, 2)[:, None]
        for conv, norm, act in self.layers if seq is None else self.layers[:-1]:
            x = act(norm(F.max_pool2d(conv(x), 3, stride=2, padding=1)))
            if x_len is not None:
                x_len = (x_len - 1) // 2 + 1
        if seq is None:
            return _flatten(x), x_len
        conv, norm, act = self.layers[-1]
        if x_len is not None:
            x_len = (x_len - 1) // 2 + 1
        t_in = x.shape[-1]
        total = (t_in - 1) // 2 + 1
        if total % seq.size:
            return _flatten(act(norm(F.max_pool2d(conv(x), 3, stride=2, padding=1)))), x_len, None
        span = sequence.even(total, seq)
        # the pool's outputs [o, o + L) read the conv's [2o - 1, 2(o + L)),
        # of which [a, b) lie inside the sequence
        lo, hi = 2 * span.start - 1, 2 * (span.start + span.length)
        a, b = max(lo, 0), min(hi, t_in)
        k, p = conv.kernel_size[1], conv.padding[1]
        y = F.conv2d(sequence.window(x, a - p, b - p + k - 1), *_weights(conv, x),
                     padding=(conv.padding[0], 0))
        y = F.pad(y, (a - lo, hi - b), value=-math.inf)
        y = F.max_pool2d(y, 3, stride=2, padding=(1, 0))
        return _flatten(act(_sharded_norm(norm, y))), x_len, span


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

    def forward(self, x, x_len, seq=None):
        """(features, lengths); with a seq group ``seq`` also the span of the
        frames returned (None: whole), from ``_sharded_last``."""
        x = x.transpose(1, 2)[:, None]
        for layer in self.layers if seq is None else self.layers[:-1]:
            x = layer(x)
            if x_len is not None:
                x_len = x_len // 2
        if seq is None:
            return _flatten(x), x_len
        return self._sharded_last(x, x_len, seq)

    def _sharded_last(self, x, x_len, seq):
        """The last stage under sequence parallelism, the whole input on
        every rank: a rank whose pooled frames [o, o + L) split evenly runs
        the first conv on the frames [2o, 2o + 2L) it pools (the last rank
        to the end: the frame the pool drops still counts in BatchNorm's
        statistics) from their window of the input, its BatchNorm over the
        data x seq group; takes the first conv's activations at the second
        conv's reach from its neighbours (``sequence.halo``, zeros past the
        ends as that conv's padding); runs the second conv, its BatchNorm
        and the pool on its frames. Otherwise the stage runs whole.
        (features, lengths, span or None)."""
        conv_a, norm_a, act_a, conv_b, norm_b, act_b, pool = self.layers[-1]
        if x_len is not None:
            x_len = x_len // 2
        t_in = x.shape[-1]
        total = t_in // 2
        p = conv_b.padding[1]
        span = sequence.even(total, seq) if total % seq.size == 0 else None
        if span is None or 2 * span.length < p:
            return _flatten(self.layers[-1](x)), x_len, None
        lo = 2 * span.start
        hi = t_in if span.start + span.length == total else lo + 2 * span.length
        k, pa = conv_a.kernel_size[1], conv_a.padding[1]
        y = F.conv2d(sequence.window(x, lo - pa, hi - pa + k - 1), *_weights(conv_a, x),
                     padding=(conv_a.padding[0], 0))
        y = sequence.halo(act_a(_sharded_norm(norm_a, y)), p, p, seq, dim=3)
        y = F.conv2d(y, *_weights(conv_b, y), padding=(conv_b.padding[0], 0))
        y = act_b(_sharded_norm(norm_b, y))
        return _flatten(pool(y[..., :2 * span.length])), x_len, span


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
        self.tp = None

    def forward(self, x, generator=None, span=None):
        return run_parallel(self.layers, x, generator, self.tp, span)


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

    def forward(self, x, mask=None, generator=None, span=None):
        """Under sequence parallelism x holds this rank's frames ``span``,
        the output its rows (``sequence.strided(span, S)`` in a strided
        layer)."""
        out = span if span is None else sequence.strided(span, self.mhsa.stride)
        return self.dropout(self.mhsa(self.norm(x), mask, span), generator, out)


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
            Dropout(dropout, time_dim=2),
            Transpose(1, 2),
        )
        self.tp = None

    def forward(self, x, generator=None, span=None):
        """x (B, T, D) -> (B, T', E). Under sequence parallelism x holds
        this rank's frames ``span`` of the sequence: the depthwise conv
        takes its neighbours' edge frames (parallel/sequence.conv1d_time),
        its output the frames ``sequence.strided(span, stride)``, and
        BatchNorm the data x seq statistics."""
        if span is None:
            return run_parallel(self.layers, x, generator, self.tp)
        layers = self.layers
        y = run_parallel(layers[:4], x, generator, self.tp)      # LN, pointwise, GLU
        y, out = sequence.conv1d_time(layers[4], y, span)
        y = layers[7](layers[6](layers[5](y, sharded=True)))
        return layers[9](layers[8](y, generator, out))

    def step(self, x, state):
        """One frame x (B, 1, D) of a causal module with no stride, in eval
        mode, given the depthwise conv's last K-1 inputs ``state`` (B, E,
        K-1): (the frame's output (B, 1, E), the state shifted by its
        input). Under tensor parallelism the state holds the rank's E/n
        channels, as its depthwise conv does."""
        layers = self.layers
        g = run_parallel(layers[:4], x, None, self.tp)  # LN, pointwise, GLU: (B, E, 1)
        window = torch.cat([state.to(g.dtype), g], dim=2)
        y = layers[4](window)[..., -1:]                # the causal conv's output at this frame
        return run_layers(layers[5:], y, None), window[..., 1:]


# ---------------------------------------------------------------- ContextNet


def _channels_first(layer, x):
    """``layer`` (a Conv1d or BatchNorm1d over (B, C, T)) of x (B, T, C)."""
    return layer(x.transpose(1, 2)).transpose(1, 2)


class SqueezeAndExcitationModule(nn.Module):
    """x (B, T, D) scaled per channel by sigmoid(fc2(act(fc1(mean_T x))))
    (modules.py:352-363): the mean over every frame, padded ones included,
    as the JAX module's."""

    def __init__(self, dim: int, reduction_ratio: int, inner_act: str = "relu"):
        super().__init__()
        self.fc1 = Linear(dim, dim // reduction_ratio)
        self.act = _act(inner_act)
        self.fc2 = Linear(dim // reduction_ratio, dim)

    def forward(self, x):
        scale = self.fc2(self.act(self.fc1(x.mean(dim=1, keepdim=True))))
        return x * torch.sigmoid(scale)


class DepthwiseSeparableConv1d(nn.Module):
    """x (B, T, C) -> depthwise Conv1d (kernel, stride; 'same' or causal
    padding) -> pointwise projection to ``features`` -> BatchNorm -> swish
    (modules.py:366-382)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int, stride: int = 1,
                 causal: bool = False):
        super().__init__()
        self.dw = Conv1d(in_channels, in_channels, kernel_size, stride=stride,
                         groups=in_channels, padding="causal" if causal else None)
        self.pw = Linear(in_channels, features)
        self.bn = BatchNorm1d(features)

    def forward(self, x):
        return swish(_channels_first(self.bn, self.pw(_channels_first(self.dw, x))))


class ContextNetBlock(nn.Module):
    """``num_layers`` depthwise-separable convs (the last with the stride),
    squeeze-and-excitation (swish inside) when ``se_ratio`` is set, and with
    ``residual`` swish(y + BatchNorm(pointwise strided conv of x))
    (modules.py:385-411). x (B, T, C) -> (B, T', features)."""

    def __init__(self, in_features: int, num_layers: int, features: int, kernel_size: int,
                 stride: int = 1, causal: bool = False, se_ratio: Optional[int] = None,
                 residual: bool = True):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"conv_{i}", DepthwiseSeparableConv1d(
                in_features if i == 0 else features, features, kernel_size,
                stride=stride if i == num_layers - 1 else 1, causal=causal))
        self.se = (SqueezeAndExcitationModule(features, se_ratio, "swish")
                   if se_ratio is not None else None)
        self.residual = residual
        if residual:
            self.res = Conv1d(in_features, features, 1, stride=stride)
            self.res_bn = BatchNorm1d(features)

    def forward(self, x):
        y = x
        for i in range(self.num_layers):
            y = getattr(self, f"conv_{i}")(y)
        if self.se is not None:
            y = self.se(y)
        if self.residual:
            y = swish(y + _channels_first(self.res_bn, _channels_first(self.res, x)))
        return y


class ContextNetSubsampling(nn.Module):
    """Eight ContextNet blocks of ``dim_model`` features, blocks 3 and 7 of
    stride 2 (modules.py:414-438): block 0 one conv with neither SE nor
    residual, the others five convs with SE (ratio 8) and the residual;
    lengths (l-1)//2 + 1 twice. x (B, T, in_features) -> ((B, T', D),
    lengths). The JAX package registers it in no subsampling table, and
    neither does the port."""

    def __init__(self, in_features: int, dim_model: int, kernel_size: int, causal: bool = False):
        super().__init__()
        for block_id in range(8):
            self.add_module(f"block_{block_id}", ContextNetBlock(
                in_features if block_id == 0 else dim_model,
                num_layers=1 if block_id == 0 else 5, features=dim_model,
                kernel_size=kernel_size, stride=2 if block_id in (3, 7) else 1, causal=causal,
                se_ratio=None if block_id == 0 else 8, residual=block_id != 0))

    def forward(self, x, x_len=None):
        for block_id in range(8):
            x = getattr(self, f"block_{block_id}")(x)
        if x_len is not None:
            x_len = ((x_len - 1) // 2 + 1 - 1) // 2 + 1
        return x, x_len
