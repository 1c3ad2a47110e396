"""Multi-head self-attention: the relative-position branches.

Counterpart of efficientconformer_tpu/models/attentions.py. The port has the
branches the shipped configs, their causal and limited-context variants and
the LM-Transformer take:
  * non-causal rel-pos attention with a key-only mask, either grouped with
    an odd group size G (efficientconformer_tpu/models/attentions.py:249-349)
    or plain (:448-519), every attention layer of the Efficient Conformer
    encoders at full context. Both call the fused rel-pos attention
    (ops/rel_attention.py), a CUDA kernel in each direction on the card; its
    autograd Function carries the gradients back to the query, key, value
    and pos projections and to u and v (through delta = v - u and the folded
    weights W, whose gather scatters dW back onto pos_layer.weight). The JAX
    package factorizes exactly these cases (``_factorize_on``, :80-90);
  * every other rel-pos case with odd G, the Transformer-XL skewing path:
    causal layers (a causal encoder, the LM-Transformer) and layers under a
    full (T, T) mask (limited left/right context, streaming), grouped
    (:332-348) or plain (:504-518). The rel-pos scores qv . e over the
    relative window (grouped: the grouped window, folded G-fold into the head
    dim) are skewed to absolute key positions (ops/attention.rel_to_abs_causal
    or rel_to_abs_full), scaled and added to the mask (grouped: one entry
    per group, ``mask[::G, ::G]``), and the resulting (B, H, Nq, Nk) bias goes
    to the bias attention (ops/bias_attention.py), a CUDA kernel in each
    direction on the card, which returns the bias's gradient to the skewing
    path. Under a finite left context the query rows past a row's length
    plus the left context see no valid key: such a row averages V over all
    its keys, as the JAX package's does;
  * the causal plain layer's one-token ``step`` on a fixed-capacity KV cache
    with per-row write positions (:177-227), which the beam searches drive
    through the LM-Transformer: plain PyTorch, as the JAX package computes
    it outside any Pallas kernel. The growing cache (:448-459), which only
    the host Transducer beam needs, raises with its ROADMAP item.
Every other variant raises NotImplementedError naming its ROADMAP item.

Parameter names are the original PyTorch repo's (query_layer, key_layer,
value_layer, output_layer, pos_layer, u, v), so utils/weights.py maps them.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from efficientconformer_torch.models.layers import Linear
from efficientconformer_torch.ops import attention as A
from efficientconformer_torch.ops import bias_attention as BA
from efficientconformer_torch.ops import masks as M
from efficientconformer_torch.ops import pos_enc as P
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
        if group_size % 2 == 0:
            raise NotImplementedError(
                "grouped attention with even G: ROADMAP Queue 1 item 15")
        self.dim_model, self.num_heads, self.group_size = dim_model, num_heads, group_size
        self.causal = causal
        self.query_layer = Linear(dim_model, dim_model)
        self.key_layer = Linear(dim_model, dim_model)
        self.value_layer = Linear(dim_model, dim_model)
        self.output_layer = Linear(dim_model, dim_model)
        self.pos_layer = Linear(dim_model, dim_model)
        self.u = nn.Parameter(torch.zeros(dim_model))
        self.v = nn.Parameter(torch.zeros(dim_model))
        self._step_table = None      # (key, table) of the last fixed-cache capacity

    def init_rel_biases_(self, generator: torch.Generator) -> None:
        """u and v: Xavier-uniform over (H, G*D/H), as the JAX package."""
        dim_head = self.group_size * self.dim_model // self.num_heads
        bound = math.sqrt(6.0 / (self.num_heads + dim_head))
        with torch.no_grad():
            self.u.uniform_(-bound, bound, generator=generator)
            self.v.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, T, D); mask (B or 1, 1, 1, T) with 1.0 at padded keys, a
        full (B or 1, 1, T, T) mask with 1.0 where query i may not see key
        j, or None."""
        if self.causal or (mask is not None and mask.shape[-2] != 1):
            return self._skewed(x, mask)
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

    def _skewed(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """The Transformer-XL skewing path (attentions.py:332-348 grouped,
        :504-518 plain): qu = q + u attends to the keys under the bias
        rel_to_abs(qv . e) / sqrt(dh) + mask * NEG_INF, with qv = q + v and
        e the pos projection of the relative window. In bf16 the rel scores
        are bf16 and the mask fp32, so the bias is fp32; the JAX package's
        ``_attend`` (:143) casts it to the scores' bf16, where the mask's
        -1e9 swamps the rel scores of a masked key all the same."""
        d, h, g = self.dim_model, self.num_heads, self.group_size
        dh = g * d // h
        if x.device.type != "cpu" and dh > BA.MAX_WIDTH:
            raise NotImplementedError(
                f"causal or limited-context attention at head width {dh}: the bias "
                f"kernels take at most {BA.MAX_WIDTH} (ROADMAP Queue 2 items 3-5)")
        t_in = x.shape[1]
        q = self.query_layer(x)
        k = self.key_layer(x)
        v = self.value_layer(x)
        u, vb = self.u.to(x.dtype), self.v.to(x.dtype)
        if g > 1:
            q, _ = M.pad_to_multiple(q, g)
            k, _ = M.pad_to_multiple(k, g)
            v, _ = M.pad_to_multiple(v, g)
            mask = M.pad_mask_to_multiple(mask, g)
            if mask is not None:
                mask = mask[:, :, ::g, ::g]
            t = q.shape[1]
            qu, qv = A.group_time(q + u, h, g), A.group_time(q + vb, h, g)
            kh, vh = A.group_time(k, h, g), A.group_time(v, h, g)
            window = P.grouped_relative_encoding(t, d, g, self.causal, x.device)
        else:
            qu, qv = A.split_heads(q + u, h), A.split_heads(q + vb, h)
            kh, vh = A.split_heads(k, h), A.split_heads(v, h)
            window = P.relative_encoding(t_in, d, self.causal, x.device)
        e = self.pos_layer(window.to(x.dtype))
        rel = torch.einsum("bhqd,lhd->bhql", qv, e.reshape(-1, h, dh))
        skew = A.rel_to_abs_causal if self.causal else A.rel_to_abs_full
        bias = skew(rel) / math.sqrt(dh)
        if mask is not None:
            bias = bias + mask * A.NEG_INF
        o, _ = BA.bias_attention(qu, kh, vh, bias, 1.0 / math.sqrt(dh))
        # ungroup_time is merge_heads when G = 1
        return self.output_layer(A.ungroup_time(o, d)[:, :t_in])

    def step(self, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             at: "StepPositions") -> torch.Tensor:
        """One token through the causal layer on a fixed-capacity KV cache
        (attentions.py:177-227). x (B, 1, D); k and v (B, L, D) fp32 caches,
        into which the token's key and value are written in place, at the
        positions of ``at`` (nothing is written once a row's position
        reaches L, as XLA drops an out-of-bounds scatter); the token attends
        to slots 0..pos_b, the rel-pos score of slot j taken at distance
        pos_b - j, with an fp32 softmax. Returns (B, 1, D)."""
        if not self.causal:
            raise NotImplementedError("a KV-cache step of a non-causal layer")
        d, h = self.dim_model, self.num_heads
        dh = d // h
        b, cap = k.shape[:2]
        q = self.query_layer(x)[:, 0]
        for cache, layer in ((k, self.key_layer), (v, self.value_layer)):
            new = layer(x)[:, 0].to(cache.dtype)
            cache[at.rows, at.at] = torch.where(at.inside, new, cache[at.rows, at.at])
        qu = (q + self.u.to(x.dtype)).reshape(b, h, dh)
        qv = (q + self.v.to(x.dtype)).reshape(b, h, dh)
        content = torch.einsum("bhd,bjhd->bhj", qu, k.view(b, cap, h, dh).to(x.dtype))
        rel = torch.einsum("bhd,lhd->bhl", qv, self._rel_table(cap, x.dtype, x.device))
        rel = rel.gather(-1, at.rel_idx[:, None, :].expand(b, h, cap))
        scores = ((content + rel) / math.sqrt(dh)).masked_fill(at.invalid, A.NEG_INF)
        p_att = torch.softmax(scores.to(torch.float32), dim=-1)
        o = torch.einsum("bhj,bjhd->bhd", p_att.to(v.dtype), v.view(b, cap, h, dh))
        return self.output_layer(o.reshape(b, 1, d).to(x.dtype))

    def _rel_table(self, cap: int, dtype, device) -> torch.Tensor:
        """The pos projection of the causal window of ``cap`` distances,
        (cap, H, dh). Outside autograd it is kept for the next step while
        the pos layer's parameters are unchanged (their in-place updates
        bump their versions)."""
        w, bias = self.pos_layer.weight, self.pos_layer.bias
        key = (cap, dtype, device, w.data_ptr(), w._version, bias._version)
        if self._step_table is not None and self._step_table[0] == key:
            return self._step_table[1]
        d = self.dim_model
        table = self.pos_layer(P.relative_encoding(cap, d, causal=True, device=device).to(dtype))
        table = table.reshape(cap, self.num_heads, d // self.num_heads)
        if not torch.is_grad_enabled():
            self._step_table = (key, table)
        return table


class StepPositions(NamedTuple):
    """Where a fixed-cache step writes and what it attends, the same for
    every layer of one decoder step: rows (B,); at (B,), the write slot,
    kept inside the cache; inside (B, 1), whether the position is; rel_idx
    (B, L), the entry of the rel-pos table that slot j reads (the table's
    entry i holds distance L-1 - i, so j + L-1 - pos_b); invalid (B, 1, L),
    the slots past pos_b."""

    rows: torch.Tensor
    at: torch.Tensor
    inside: torch.Tensor
    rel_idx: torch.Tensor
    invalid: torch.Tensor


def step_positions(pos: torch.Tensor, cap: int) -> StepPositions:
    """The StepPositions of rows at positions pos (B,) in caches of ``cap``
    slots."""
    slots = torch.arange(cap, device=pos.device)[None, :]
    return StepPositions(
        rows=torch.arange(pos.shape[0], device=pos.device), at=pos.clamp(max=cap - 1),
        inside=(pos < cap)[:, None], rel_idx=(slots + (cap - 1) - pos[:, None]).clamp(0, cap - 1),
        invalid=(slots > pos[:, None])[:, None])
