"""Conformer and Transformer blocks.

Counterpart of efficientconformer_tpu/models/blocks.py. ConformerBlock:
x + ½FFN -> x + MHSA -> residual + Conv -> x + ½FFN -> LayerNorm. The residual
around the convolution module is a strided pointwise conv when the width
expands, a strided slice when the block only strides. TransformerBlock (the
LM-Transformer's): pre-LN, x + MHSA -> x + FFN (relu, no inner dropout), no
final norm; its ``step`` runs one token on a fixed-capacity KV cache. The
training state is the module's own (``train()``/``eval()``); the generator
for dropout is handed down to each module.
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
            c.dim_model, c.dim_expand, c.kernel_size, c.dropout, stride=c.conv_stride,
            causal=c.causal)
        if c.dim_model != c.dim_expand:
            self.conv_res = nn.Sequential(
                Transpose(1, 2), Conv1d(c.dim_model, c.dim_expand, 1, stride=c.conv_stride),
                Transpose(1, 2))
        self.feed_forward_module2 = FeedForwardModule(
            c.dim_expand, c.dim_expand * c.ff_ratio, c.dropout)
        self.norm = LayerNorm(c.dim_expand)

    def forward(self, x, mask=None, generator=None):
        c = self.cfg
        x = x + 0.5 * self.feed_forward_module1(x, generator)
        x = x + self.multi_head_self_attention_module(x, mask, generator)
        if c.dim_model != c.dim_expand:
            res = self.conv_res(x)
        else:
            res = x[:, :: c.conv_stride]
        x = res + self.convolution_module(x, generator)
        x = x + 0.5 * self.feed_forward_module2(x, generator)
        return self.norm(x)


class TransformerBlock(nn.Module):
    """blocks.py:90-125, a causal rel-pos (or absolute) self-attention
    module and a relu feed-forward module."""

    def __init__(self, dim_model: int, ff_ratio: int, num_heads: int, dropout: float,
                 relative_pos_enc: bool):
        super().__init__()
        self.multi_head_self_attention_module = MultiHeadSelfAttentionModule(
            dim_model, num_heads, dropout, relative_pos_enc=relative_pos_enc, causal=True)
        self.feed_forward_module = FeedForwardModule(
            dim_model, dim_model * ff_ratio, dropout, act="relu", inner_dropout=False)

    def forward(self, x, mask=None, generator=None):
        x = x + self.multi_head_self_attention_module(x, mask, generator)
        return x + self.feed_forward_module(x, generator)

    def step(self, x, k, v, at):
        """One token x (B, 1, D) on the attention's KV cache k, v (B, L, D),
        written in place at ``at`` (attentions.StepPositions; blocks.py
        :105-125, train=False). In eval mode, where the dropouts are the
        identity."""
        att = self.multi_head_self_attention_module
        x = x + att.dropout(att.mhsa.step(att.norm(x), k, v, at))
        return x + self.feed_forward_module(x)
