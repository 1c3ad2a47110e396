"""Conformer and Transformer blocks.

Counterpart of efficientconformer_tpu/models/blocks.py. ConformerBlock:
x + ½FFN -> x + MHSA -> residual + Conv -> x + ½FFN -> LayerNorm. A strided
attention (``att_stride`` S) keeps every S-th query, and its residual is
``x[:, ::S]`` (blocks.py:56-57). The residual around the convolution module
is a strided pointwise conv when the width expands, a strided slice when
the block only strides. With ``vn_std`` (the Conformer decoder's blocks)
the modules' weights carry variational noise; a causal block's ``step``
runs one token on its attention's fixed-capacity KV cache and its
convolution's last inputs (the Conformer decoder's). TransformerBlock (the
LM-Transformer's): pre-LN, x + MHSA -> x + FFN (relu, no inner dropout), no
final norm; it passes a growing KV cache in and out, as the JAX block does,
and its ``step`` runs one token on a fixed-capacity KV cache. The
training state is the module's own (``train()``/``eval()``); the generator
for dropout is handed down to each module. Under tensor parallelism the
blocks are unchanged: parallel/tensor.shard_model_ gives their feed-forward,
attention and convolution modules the model group, and their residuals,
LayerNorms and the strided convolution residual stay replicated.
"""

from __future__ import annotations

from typing import Optional

from torch import nn

from efficientconformer_torch.config import BlockConfig
from efficientconformer_torch.models.layers import Conv1d, LayerNorm, Transpose
from efficientconformer_torch.models.modules import (
    ConvolutionModule,
    FeedForwardModule,
    MultiHeadSelfAttentionModule,
)
from efficientconformer_torch.parallel import sequence


class ConformerBlock(nn.Module):
    def __init__(self, cfg: BlockConfig, vn_std: Optional[float] = None):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.feed_forward_module1 = FeedForwardModule(
            c.dim_model, c.dim_model * c.ff_ratio, c.dropout, vn_std=vn_std)
        self.multi_head_self_attention_module = MultiHeadSelfAttentionModule(
            c.dim_model, c.num_heads, c.dropout, relative_pos_enc=c.relative_pos_enc,
            causal=c.causal, group_size=c.att_group_size, kernel_size=c.att_kernel_size,
            stride=c.att_stride, linear_att=c.linear_att, vn_std=vn_std,
        )
        self.convolution_module = ConvolutionModule(
            c.dim_model, c.dim_expand, c.kernel_size, c.dropout, stride=c.conv_stride,
            causal=c.causal, vn_std=vn_std)
        if c.dim_model != c.dim_expand:
            self.conv_res = nn.Sequential(
                Transpose(1, 2), Conv1d(c.dim_model, c.dim_expand, 1, stride=c.conv_stride),
                Transpose(1, 2))
        self.feed_forward_module2 = FeedForwardModule(
            c.dim_expand, c.dim_expand * c.ff_ratio, c.dropout, vn_std=vn_std)
        self.norm = LayerNorm(c.dim_expand)

    def forward(self, x, mask=None, generator=None, span=None):
        """x (B, T, D) -> (B, T', E); under sequence parallelism x holds
        this rank's frames ``span`` (parallel/sequence.Span) and the output
        the frames ``sequence.strided(span, stride)``: a strided residual
        (of the attention or of the convolution) keeps the frames at global
        multiples of its stride, from the rank's first such frame on."""
        c = self.cfg
        x = x + 0.5 * self.feed_forward_module1(x, generator, span)
        att = self.multi_head_self_attention_module(x, mask, generator, span)
        if c.att_stride > 1:
            x = x[:, (-span.start % c.att_stride if span is not None else 0):: c.att_stride]
            span = sequence.strided(span, c.att_stride) if span is not None else None
        x = x + att
        first = 0
        out = span
        if span is not None:
            first = -span.start % c.conv_stride
            out = sequence.strided(span, c.conv_stride)
        if c.dim_model != c.dim_expand:
            res = self.conv_res(x[:, first:])
        else:
            res = x[:, first:: c.conv_stride]
        x = res + self.convolution_module(x, generator, span)
        x = x + 0.5 * self.feed_forward_module2(x, generator, out)
        return self.norm(x)

    def step(self, x, k, v, conv_state, at):
        """One token x (B, 1, D) of a causal block with no stride or
        expansion (the Conformer decoder's), in eval mode: the attention on
        its fixed-capacity KV cache k, v (B, L, D), written in place at
        ``at`` (attentions.StepPositions), the convolution on its last K-1
        inputs ``conv_state`` (B, D, K-1). Returns (x, the new conv state)."""
        x = x + 0.5 * self.feed_forward_module1(x)
        att = self.multi_head_self_attention_module
        x = x + att.dropout(att.mhsa.step(att.norm(x), k, v, at))
        y, conv_state = self.convolution_module.step(x, conv_state)
        x = x + y
        x = x + 0.5 * self.feed_forward_module2(x)
        return self.norm(x), conv_state


class TransformerBlock(nn.Module):
    """blocks.py:90-125, a causal rel-pos (or absolute) self-attention
    module and a relu feed-forward module."""

    def __init__(self, dim_model: int, ff_ratio: int, num_heads: int, dropout: float,
                 relative_pos_enc: bool, vn_std: Optional[float] = None):
        super().__init__()
        self.multi_head_self_attention_module = MultiHeadSelfAttentionModule(
            dim_model, num_heads, dropout, relative_pos_enc=relative_pos_enc, causal=True,
            vn_std=vn_std)
        self.feed_forward_module = FeedForwardModule(
            dim_model, dim_model * ff_ratio, dropout, act="relu", inner_dropout=False,
            vn_std=vn_std)

    def forward(self, x, mask=None, generator=None, hidden=None):
        """(x, the attention's new KV cache): x attends to the keys and
        values of ``hidden`` ({"k", "v"} of (B, Th, D), or None) followed by
        its own (blocks.py:105-125)."""
        att = self.multi_head_self_attention_module
        y, hidden = att.mhsa.forward_cached(att.norm(x), mask, hidden)
        x = x + att.dropout(y, generator)
        return x + self.feed_forward_module(x, generator), hidden

    def step(self, x, k, v, at):
        """One token x (B, 1, D) on the attention's KV cache k, v (B, L, D),
        written in place at ``at`` (attentions.StepPositions; blocks.py
        :105-125, train=False). In eval mode, where the dropouts are the
        identity."""
        att = self.multi_head_self_attention_module
        x = x + att.dropout(att.mhsa.step(att.norm(x), k, v, at))
        return x + self.feed_forward_module(x)
