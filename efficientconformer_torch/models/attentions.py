"""Multi-head self-attention: the factorized relative-position branches.

Counterpart of efficientconformer_tpu/models/attentions.py. The port has the
two branches every attention layer of the shipped Efficient Conformer CTC
configs takes: non-causal rel-pos attention with a key-only mask, either
grouped with an odd group size G (efficientconformer_tpu/models/
attentions.py:249-349) or plain (:448-519). Both call the fused rel-pos
attention (ops/rel_attention.py), a CUDA kernel on the card. Every other
variant raises NotImplementedError naming its ROADMAP item.

Parameter names are the original PyTorch repo's (query_layer, key_layer,
value_layer, output_layer, pos_layer, u, v), so utils/weights.py maps them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from efficientconformer_torch.models.layers import Linear
from efficientconformer_torch.ops import attention as A
from efficientconformer_torch.ops import masks as M
from efficientconformer_torch.ops import rel_attention as RA
from efficientconformer_torch.ops import rel_factorize as RF


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, dim_model: int, num_heads: int, causal: bool = False,
                 group_size: int = 1, kernel_size: Optional[int] = None, stride: int = 1,
                 linear_att: bool = False, relative_pos_enc: bool = False):
        super().__init__()
        if not relative_pos_enc:
            raise NotImplementedError(
                "absolute/linear attention: ROADMAP Queue 1 item 15")
        if linear_att or kernel_size is not None or stride > 1:
            raise NotImplementedError(
                "local, strided and linear attention: ROADMAP Queue 1 item 15")
        if causal:
            raise NotImplementedError(
                "causal rel-pos attention (skewing path): ROADMAP Queue 1 item 11")
        if group_size % 2 == 0:
            raise NotImplementedError(
                "grouped attention with even G: ROADMAP Queue 1 item 15")
        self.dim_model, self.num_heads, self.group_size = dim_model, num_heads, group_size
        self.query_layer = Linear(dim_model, dim_model)
        self.key_layer = Linear(dim_model, dim_model)
        self.value_layer = Linear(dim_model, dim_model)
        self.output_layer = Linear(dim_model, dim_model)
        self.pos_layer = Linear(dim_model, dim_model)
        self.u = nn.Parameter(torch.zeros(dim_model))
        self.v = nn.Parameter(torch.zeros(dim_model))

    def init_rel_biases_(self, generator: torch.Generator) -> None:
        """u and v: Xavier-uniform over (H, G*D/H), as the JAX package."""
        dim_head = self.group_size * self.dim_model // self.num_heads
        bound = math.sqrt(6.0 / (self.num_heads + dim_head))
        with torch.no_grad():
            self.u.uniform_(-bound, bound, generator=generator)
            self.v.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, T, D), mask (B, 1, 1, T) with 1.0 at padded keys, or None."""
        if mask is not None and mask.shape[-2] != 1:
            raise NotImplementedError(
                "full (T, T) attention masks (streaming): ROADMAP Queue 1 item 12")
        d, h, g = self.dim_model, self.num_heads, self.group_size
        t_in = x.shape[1]
        q = self.query_layer(x)
        k = self.key_layer(x)
        v = self.value_layer(x)
        u = self.u.to(x.dtype)
        # the pos layer's (D_in, D_out) kernel; its bias cancels in the softmax
        pos_kernel = self.pos_layer.weight.T.to(torch.float32)
        vu = (self.v - self.u).to(torch.float32)

        if g > 1:
            qp, _ = M.pad_to_multiple(q, g)
            kp, _ = M.pad_to_multiple(k, g)
            vp, _ = M.pad_to_multiple(v, g)
            mask_p = M.pad_mask_to_multiple(mask, g)
            dh = g * d // h
            qu = A.group_time(qp + u, h, g)
            kh = A.group_time(kp, h, g)
            vh = A.group_time(vp, h, g)
            # a group of keys is valid iff its first frame is
            bias = mask_p[:, :, ::g, ::g] * A.NEG_INF if mask_p is not None else None
            # group_time folds G frames into the head dim, so qv - qu is the
            # bias difference tiled G times
            delta = vu.repeat(g).reshape(h, dh)
            w_h = RF.rel_w_grouped(h, dh, pos_kernel, g, d // 2)
        else:
            dh = d // h
            qu = A.split_heads(q + u, h)
            kh = A.split_heads(k, h)
            vh = A.split_heads(v, h)
            bias = mask * A.NEG_INF if mask is not None else None
            delta = vu.reshape(h, dh)
            w_h = RF.rel_w_plain(pos_kernel, h, d // 2)

        rowtab, keytab = RF.rel_tables(qu.shape[2], kh.shape[2], d, g, x.device)
        o, _ = RA.relpos_attention(qu, kh, vh, delta, w_h, rowtab, keytab, bias,
                                   1.0 / math.sqrt(dh))
        # ungroup_time is merge_heads when G = 1
        return self.output_layer(A.ungroup_time(o, d)[:, :t_in])
