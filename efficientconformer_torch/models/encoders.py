"""Conformer encoder, inference path.

Counterpart of efficientconformer_tpu/models/encoders.py:ConformerEncoder:
log-mel frontend (fp32) -> optional cast to ``compute_dtype`` -> Conv2d
subsampling -> key-padding mask -> linear projection -> Conformer blocks.
After a strided block the (B, 1, 1, T) mask is sliced ``[::s, ::s]`` and the
lengths become (l-1)//s + 1. Training (SpecAugment, dropout, batch
statistics) comes with the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from efficientconformer_torch.config import resolve_block_configs
from efficientconformer_torch.models.blocks import ConformerBlock
from efficientconformer_torch.models.layers import Linear
from efficientconformer_torch.models.modules import AudioPreprocessing, Conv2dSubsampling
from efficientconformer_torch.ops.masks import padding_mask


class ConformerEncoder(nn.Module):
    def __init__(self, params: dict):
        super().__init__()
        p = params
        if p["subsampling_module"] != "Conv2d":
            raise NotImplementedError(
                f"{p['subsampling_module']} subsampling: ROADMAP Queue 1 item 3")
        if p.get("causal", False):
            raise NotImplementedError("causal encoder: ROADMAP Queue 1 item 12")
        blocks = resolve_block_configs(p)
        dtype = p.get("compute_dtype")
        self.compute_dtype = getattr(torch, dtype) if dtype else None
        self.left_context = p.get("left_context", p["max_pos_encoding"])
        self.right_context = p.get("right_context", p["max_pos_encoding"])
        self.preprocessing = AudioPreprocessing(
            p["sample_rate"], p["n_fft"], p["win_length_ms"], p["hop_length_ms"],
            p["n_mels"], p["normalize"], p["mean"], p["std"])
        self.subsampling_module = Conv2dSubsampling(
            p["subsampling_layers"], p["subsampling_filters"], p["subsampling_kernel_size"],
            p["subsampling_norm"], p["subsampling_act"])
        mel = p["n_mels"]
        for _ in range(p["subsampling_layers"]):
            mel = (mel - 1) // 2 + 1
        self.linear = Linear(p["subsampling_filters"][-1] * mel, blocks[0].dim_model)
        self.blocks = nn.ModuleList(ConformerBlock(cfg) for cfg in blocks)

    def forward(self, x: torch.Tensor, x_len: Optional[torch.Tensor] = None):
        """x: (B, T_audio) raw waveform -> (features (B, T, D), lengths)."""
        if self.training:
            raise NotImplementedError("encoder training: ROADMAP Queue 1 item 8")
        x, x_len = self.preprocessing(x, x_len)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        x, x_len = self.subsampling_module(x, x_len)
        t = x.shape[1]
        if self.left_context < t or self.right_context < t:
            raise NotImplementedError(
                "limited attention context (streaming mask): ROADMAP Queue 1 item 12")
        mask = padding_mask(t, x_len)
        x = self.linear(x)
        for block in self.blocks:
            x = block(x, mask)
            s = block.cfg.stride
            if s > 1:
                if mask is not None:
                    mask = mask[:, :, ::s, ::s]
                if x_len is not None:
                    x_len = (x_len - 1) // s + 1
        return x, x_len
