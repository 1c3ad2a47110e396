"""Conformer building modules.

Counterpart of efficientconformer_tpu/models/modules.py. Activations are
(B, T, D) between modules. The subsampling convolution and the convolution
module run in torch's channels-first layout internally, as the original
PyTorch repo does, so that their parameters keep its names and layouts.
In training mode BatchNorm uses batch statistics (models/layers.py) and
dropout and SpecAugment draw from the generator passed to ``forward``.
"""

from __future__ import annotations

from typing import Sequence

from torch import nn

from efficientconformer_torch.models.attentions import MultiHeadSelfAttention
from efficientconformer_torch.models.layers import (
    BatchNorm1d,
    BatchNorm2d,
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


class Conv2dSubsampling(nn.Module):
    """Stack of stride-2 Conv2d -> BatchNorm -> activation layers over
    (B, C, mel, time), padding (k-1)//2 so lengths go to (l-1)//2 + 1.
    Returns (B, T', C*mel') features flattened channel-major."""

    def __init__(self, num_layers: int, filters: Sequence[int], kernel_size: int,
                 norm: str, act: str):
        super().__init__()
        if norm != "batch" or act != "swish":
            raise NotImplementedError(
                f"subsampling norm {norm!r} / act {act!r}: the port has batch + swish "
                "(EfficientConformerCTCSmall); other variants with ROADMAP Queue 1 item 3")
        p = (kernel_size - 1) // 2
        chans = [1] + list(filters)
        self.layers = nn.ModuleList(
            nn.Sequential(
                Conv2d(chans[i], chans[i + 1], kernel_size, stride=2, padding=p),
                BatchNorm2d(chans[i + 1]),
                Swish(),
            )
            for i in range(num_layers)
        )

    def forward(self, x, x_len):
        x = x.transpose(1, 2)[:, None]                    # (B, 1, mel, T)
        for layer in self.layers:
            x = layer(x)
            if x_len is not None:
                x_len = (x_len - 1) // 2 + 1
        b, c, m, t = x.shape
        return x.reshape(b, c * m, t).transpose(1, 2), x_len


class FeedForwardModule(nn.Module):
    """LN -> Linear(ffn) -> act -> [drop] -> Linear(dim) -> drop: swish with
    the inner dropout in a Conformer block, relu without it in a
    Transformer block (modules.py:247-267)."""

    def __init__(self, dim_model: int, dim_ffn: int, dropout: float, act: str = "swish",
                 inner_dropout: bool = True):
        super().__init__()
        inner = [Dropout(dropout)] if inner_dropout else []
        self.layers = nn.Sequential(
            LayerNorm(dim_model),
            Linear(dim_model, dim_ffn),
            {"swish": Swish, "relu": nn.ReLU}[act](),
            *inner,
            Linear(dim_ffn, dim_model),
            Dropout(dropout),
        )

    def forward(self, x, generator=None):
        return run_layers(self.layers, x, generator)


class MultiHeadSelfAttentionModule(nn.Module):
    """Pre-LN -> self-attention -> dropout."""

    def __init__(self, dim_model: int, num_heads: int, dropout: float,
                 relative_pos_enc: bool = False, causal: bool = False, group_size: int = 1,
                 kernel_size=None, stride: int = 1, linear_att: bool = False):
        super().__init__()
        self.norm = LayerNorm(dim_model)
        self.mhsa = MultiHeadSelfAttention(
            dim_model, num_heads, causal=causal, group_size=group_size,
            kernel_size=kernel_size, stride=stride, linear_att=linear_att,
            relative_pos_enc=relative_pos_enc,
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
                 stride: int = 1, causal: bool = False):
        super().__init__()
        self.layers = nn.Sequential(
            LayerNorm(dim_model),
            Transpose(1, 2),
            Conv1d(dim_model, 2 * dim_expand, 1),
            Glu(dim=1),
            Conv1d(dim_expand, dim_expand, kernel_size, stride=stride, groups=dim_expand,
                   padding="causal" if causal else None),
            BatchNorm1d(dim_expand),
            Swish(),
            Conv1d(dim_expand, dim_expand, 1),
            Dropout(dropout),
            Transpose(1, 2),
        )

    def forward(self, x, generator=None):
        return run_layers(self.layers, x, generator)
