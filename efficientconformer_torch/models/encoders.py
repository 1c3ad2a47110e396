"""Conformer encoder.

Counterpart of efficientconformer_tpu/models/encoders.py:ConformerEncoder:
log-mel frontend (fp32) -> SpecAugment (training, fp32) -> optional cast to
``compute_dtype`` -> Conv2d subsampling -> key-padding mask -> linear
projection -> dropout -> Conformer blocks. The mask is the (B, 1, 1, T)
key-padding mask when the attention context (``left_context``,
``right_context``, both ``max_pos_encoding`` by default; the right one 0 in
a causal encoder) covers the T subsampled frames, and the (B, 1, T, T)
window + padding mask (ops/masks.streaming_mask) otherwise
(encoders.py:99-111). After a strided block the mask is sliced
``[::s, ::s]`` and the lengths become (l-1)//s + 1. In training mode
(``train()``) SpecAugment and dropout draw from the generator passed to
``forward`` and BatchNorm uses batch statistics; ``remat`` is not ported.
InterCTC (encoders.py:150-166): after each block of ``interctc_blocks`` a
tap takes p = softmax(linear_expand_i(x)) over the vocabulary and adds
linear_proj_i(p) back to x; ``forward_taps`` also returns the taps' p, each
at its block's frame rate (the original's names, ``linear_expand_{i}`` and
``linear_proj_{i}``, i the block's index).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from efficientconformer_torch.config import resolve_block_configs
from efficientconformer_torch.models.blocks import ConformerBlock
from efficientconformer_torch.models.layers import Dropout, Linear
from efficientconformer_torch.models.modules import (
    AudioPreprocessing,
    Conv2dSubsampling,
    SpecAugment,
)
from efficientconformer_torch.ops.masks import padding_mask, streaming_mask


class ConformerEncoder(nn.Module):
    def __init__(self, params: dict, vocab_size: Optional[int] = None,
                 interctc_blocks: Sequence[int] = ()):
        super().__init__()
        p = params
        if p["subsampling_module"] != "Conv2d":
            raise NotImplementedError(
                f"{p['subsampling_module']} subsampling: ROADMAP Queue 1 item 3")
        if p.get("remat"):
            raise NotImplementedError("remat (activation recomputation): ROADMAP Queue 1 item 8")
        blocks = resolve_block_configs(p)
        dtype = p.get("compute_dtype")
        self.compute_dtype = getattr(torch, dtype) if dtype else None
        self.left_context = p.get("left_context", p["max_pos_encoding"])
        self.right_context = 0 if p.get("causal", False) else p.get(
            "right_context", p["max_pos_encoding"])
        self.preprocessing = AudioPreprocessing(
            p["sample_rate"], p["n_fft"], p["win_length_ms"], p["hop_length_ms"],
            p["n_mels"], p["normalize"], p["mean"], p["std"])
        self.augment = SpecAugment(p.get("spec_augment", False), p.get("mF", 0), p.get("F", 0),
                                   p.get("mT", 0), p.get("pS", 0.0))
        self.subsampling_module = Conv2dSubsampling(
            p["subsampling_layers"], p["subsampling_filters"], p["subsampling_kernel_size"],
            p["subsampling_norm"], p["subsampling_act"])
        mel = p["n_mels"]
        for _ in range(p["subsampling_layers"]):
            mel = (mel - 1) // 2 + 1
        self.linear = Linear(p["subsampling_filters"][-1] * mel, blocks[0].dim_model)
        self.dropout = Dropout(p["Pdrop"])
        self.blocks = nn.ModuleList(ConformerBlock(cfg) for cfg in blocks)
        self.interctc_blocks = tuple(interctc_blocks)
        for i in self.interctc_blocks:
            self.add_module(f"linear_expand_{i}", Linear(blocks[i].dim_expand, vocab_size))
            self.add_module(f"linear_proj_{i}", Linear(vocab_size, blocks[i].dim_expand))

    def forward(self, x: torch.Tensor, x_len: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """x: (B, T_audio) raw waveform -> (features (B, T, D), lengths).
        ``generator`` (on x's device) feeds SpecAugment and dropout in
        training mode."""
        return self.forward_taps(x, x_len, generator)[:2]

    def forward_taps(self, x: torch.Tensor, x_len: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None):
        """``forward``'s (features, lengths) and the InterCTC taps'
        probabilities, a list of (B, T_i, V) in the compute dtype."""
        x, x_len = self.preprocessing(x, x_len)
        x = self.augment(x, x_len, generator)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        x, x_len = self.subsampling_module(x, x_len)
        t = x.shape[1]
        if self.left_context >= t and self.right_context >= t:
            mask = padding_mask(t, x_len)
        else:
            mask = streaming_mask(t, x_len, self.left_context, self.right_context, x.device)
        x = self.dropout(self.linear(x), generator)
        probs = []
        for i, block in enumerate(self.blocks):
            x = block(x, mask, generator)
            s = block.cfg.stride
            if s > 1:
                if mask is not None:
                    mask = mask[:, :, ::s, ::s]
                if x_len is not None:
                    x_len = (x_len - 1) // s + 1
            if i in self.interctc_blocks:
                p = torch.softmax(getattr(self, f"linear_expand_{i}")(x), dim=-1)
                probs.append(p)
                x = x + getattr(self, f"linear_proj_{i}")(p)
        return x, x_len, probs
