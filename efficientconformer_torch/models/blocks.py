"""Conformer block.

Counterpart of efficientconformer_tpu/models/blocks.py:ConformerBlock:
x + ½FFN -> x + MHSA -> residual + Conv -> x + ½FFN -> LayerNorm. The residual
around the convolution module is a strided pointwise conv when the width
expands, a strided slice when the block only strides.
"""

from __future__ import annotations

from torch import nn

from efficientconformer_torch.config import BlockConfig
from efficientconformer_torch.models.layers import Conv1d, LayerNorm, Transpose
from efficientconformer_torch.models.modules import (
    ConvolutionModule,
    FeedForwardModule,
    MultiHeadSelfAttentionModule,
)


class ConformerBlock(nn.Module):
    def __init__(self, cfg: BlockConfig):
        super().__init__()
        if cfg.att_stride > 1:
            raise NotImplementedError("strided attention: ROADMAP Queue 1 item 15")
        self.cfg = cfg
        c = cfg
        self.feed_forward_module1 = FeedForwardModule(
            c.dim_model, c.dim_model * c.ff_ratio, c.dropout)
        self.multi_head_self_attention_module = MultiHeadSelfAttentionModule(
            c.dim_model, c.num_heads, c.dropout, relative_pos_enc=c.relative_pos_enc,
            causal=c.causal, group_size=c.att_group_size, kernel_size=c.att_kernel_size,
            stride=c.att_stride, linear_att=c.linear_att,
        )
        self.convolution_module = ConvolutionModule(
            c.dim_model, c.dim_expand, c.kernel_size, c.dropout, stride=c.conv_stride)
        if c.dim_model != c.dim_expand:
            self.conv_res = nn.Sequential(
                Transpose(1, 2), Conv1d(c.dim_model, c.dim_expand, 1, stride=c.conv_stride),
                Transpose(1, 2))
        self.feed_forward_module2 = FeedForwardModule(
            c.dim_expand, c.dim_expand * c.ff_ratio, c.dropout)
        self.norm = LayerNorm(c.dim_expand)

    def forward(self, x, mask=None):
        c = self.cfg
        x = x + 0.5 * self.feed_forward_module1(x)
        x = x + self.multi_head_self_attention_module(x, mask)
        if c.dim_model != c.dim_expand:
            res = self.conv_res(x)
        else:
            res = x[:, :: c.conv_stride]
        x = res + self.convolution_module(x)
        x = x + 0.5 * self.feed_forward_module2(x)
        return self.norm(x)
