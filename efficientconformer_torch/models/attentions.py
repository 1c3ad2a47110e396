"""Multi-head self-attention: every variant of the JAX package.

Counterpart of efficientconformer_tpu/models/attentions.py. One module
covers the variants, chosen by its static attributes (linear_att,
relative_pos_enc, group_size, kernel_size, stride, causal), as the JAX
module does:
  * non-causal rel-pos attention with a key-only mask, either grouped with
    an odd group size G (attentions.py:249-349) or plain (:448-519), every
    attention layer of the Efficient Conformer encoders at full context.
    Both call the fused rel-pos attention (ops/rel_attention.py), a CUDA
    kernel in each direction on the card; its autograd Function carries the
    gradients back to the query, key, value and pos projections and to u
    and v (through delta = v - u and the folded weights W, whose gather
    scatters dW back onto pos_layer.weight). The JAX package factorizes
    exactly these cases (``_factorize_on``, :80-90);
  * every other full-sequence rel-pos case, the Transformer-XL skewing path:
    causal layers (a causal encoder, the LM-Transformer, the Conformer
    decoder), layers under a full (T, T) mask (limited left/right context,
    streaming), grouped layers with an even G (whose table holds position 0
    twice, so the scores are not linear in the offset and are never
    factorized, :281-284), plain (:504-518), grouped (:332-348) and strided
    (queries at every S-th frame, :380-417). The rel-pos scores qv . e over
    the relative window (grouped: the grouped window, folded G-fold into the
    head dim) are skewed to absolute key positions (ops/attention.rel_to_abs_*),
    scaled and added to the mask (grouped: one entry per group,
    ``mask[::G, ::G]``; strided: ``mask[::S]``), and the resulting (B, H, Nq,
    Nk) bias goes to the bias attention (ops/bias_attention.py), a CUDA
    kernel in each direction on the card, which returns the bias's gradient
    to the skewing path. Under a finite left context the query rows past a
    row's length plus the left context see no valid key: such a row
    averages V over all its keys, as the JAX package's does;
  * absolute attention (relative_pos_enc false), plain, grouped or strided,
    on the same bias attention with the mask as the bias (a key-only mask
    as a (B, 1, 1, T) bias, :522-579);
  * local attention (``kernel_size`` K: non-overlapping blocks of K frames
    attend within themselves, rel-pos :351-379 or absolute :534-547) and
    strided local attention (:418-447, :548-562): block-diagonal scores and
    ``softmax_attention`` in plain PyTorch, as the JAX package computes them
    outside any kernel;
  * linear attention (:229-241): softmax(q) (softmax_T(k)^T v), plain
    PyTorch, as the JAX package's, with no mask;
  * the causal plain layer's one-token ``step`` on a fixed-capacity KV cache
    with per-row write positions (:177-227), which the device beam searches
    drive through the LM-Transformer: plain PyTorch, as the JAX package
    computes it outside any Pallas kernel;
  * a growing KV cache (``forward_cached``): the past keys and values are
    prepended (by ``torch.cat``, so hypotheses may share a cache), the
    relative window reaches back over them, and the bias attention runs
    the new queries against every key. A grouped layer attends the cached
    frames from ``Th % G`` on, so that its groups stay aligned with the
    queries' (:249-259), and keeps all of them in the cache it returns.
The combinations the JAX module refuses (local or strided grouped
attention, linear attention with rel-pos encodings) raise ValueError in
modules.MultiHeadSelfAttentionModule.

Parameter names are the original PyTorch repo's (query_layer, key_layer,
value_layer, output_layer, and for rel-pos pos_layer, u, v), so
utils/weights.py maps them. With ``vn_std`` the query, key, value and
output projections carry variational noise (models/layers.py), as the JAX
module's Dense layers do; the pos projection does not.
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
                 linear_att: bool = False, relative_pos_enc: bool = False,
                 vn_std: Optional[float] = None):
        super().__init__()
        self.dim_model, self.num_heads, self.group_size = dim_model, num_heads, group_size
        self.causal, self.kernel_size, self.stride = causal, kernel_size, stride
        self.linear_att, self.relative_pos_enc = linear_att, relative_pos_enc
        self.query_layer = Linear(dim_model, dim_model, vn_std)
        self.key_layer = Linear(dim_model, dim_model, vn_std)
        self.value_layer = Linear(dim_model, dim_model, vn_std)
        self.output_layer = Linear(dim_model, dim_model, vn_std)
        if relative_pos_enc:
            self.pos_layer = Linear(dim_model, dim_model)
            self.u = nn.Parameter(torch.zeros(dim_model))
            self.v = nn.Parameter(torch.zeros(dim_model))
        self._step_table = None      # (key, table) of the last fixed-cache capacity

    def init_rel_biases_(self, generator: torch.Generator) -> None:
        """u and v: Xavier-uniform over (H, G*D/H), as the JAX package."""
        if not self.relative_pos_enc:
            return
        dim_head = self.group_size * self.dim_model // self.num_heads
        bound = math.sqrt(6.0 / (self.num_heads + dim_head))
        with torch.no_grad():
            self.u.uniform_(-bound, bound, generator=generator)
            self.v.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, T, D) -> (B, T, D), or (B, ceil(T/S), D) in a strided layer;
        mask (B or 1, 1, 1, T) with 1.0 at padded keys, a full (B or 1, 1,
        T, T) mask with 1.0 where query i may not see key j, or None."""
        if self.linear_att:
            return self._linear(x)
        if self.kernel_size is not None:
            return self._local(x, mask)
        if not self.relative_pos_enc:
            return self._absolute(x, mask)
        if self.stride > 1:
            return self._strided(x, mask)[0]
        if (self.causal or self.group_size % 2 == 0
                or (mask is not None and mask.shape[-2] != 1)):
            return self._skewed(x, mask)[0]
        return self._factorized(x, mask)

    def _factorized(self, x, mask):
        """The fused rel-pos attention (odd G, non-causal, key-only mask)."""
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

    def forward_cached(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                       hidden: Optional[dict]):
        """x (B, T, D) attends to the cached keys and values of ``hidden``
        ({"k", "v"}, each (B, Th, D), or None for none) followed by its own;
        ``mask``, if given, is (B or 1, 1, T, Th' + T), Th' the cached frames
        attended. Plain, grouped and strided rel-pos layers and plain
        absolute ones. Returns (out, the new cache {"k", "v"} of (B, Th + T,
        D))."""
        if self.linear_att or self.kernel_size is not None:
            raise ValueError("a KV cache of local or linear attention")
        if not self.relative_pos_enc:
            if self.group_size > 1 or self.stride > 1:
                raise ValueError("a KV cache of grouped or strided absolute attention")
            return self._absolute(x, mask, hidden, cached=True)
        if self.stride > 1:
            return self._strided(x, mask, hidden)
        return self._skewed(x, mask, hidden)

    def _project(self, x, hidden, keep_from: int = 0):
        """q, k and v of x, the cached keys and values from ``keep_from`` on
        prepended to k and v, and the new cache (all of the old one and x's)."""
        q = self.query_layer(x)
        k = self.key_layer(x)
        v = self.value_layer(x)
        if hidden is None:
            return q, k, v, {"k": k, "v": v}
        new_hidden = {"k": torch.cat([hidden["k"], k], dim=1),
                      "v": torch.cat([hidden["v"], v], dim=1)}
        if keep_from == 0:
            return q, new_hidden["k"], new_hidden["v"], new_hidden
        return (q, torch.cat([hidden["k"][:, keep_from:], k], dim=1),
                torch.cat([hidden["v"][:, keep_from:], v], dim=1), new_hidden)

    def _skewed(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                hidden: Optional[dict] = None):
        """The Transformer-XL skewing path (attentions.py:249-348 grouped,
        :448-518 plain): qu = q + u attends to the keys under the bias
        rel_to_abs(qv . e) / sqrt(dh) + mask * NEG_INF, with qv = q + v and
        e the pos projection of the relative window, which reaches back over
        the cached keys of ``hidden``. In bf16 the rel scores are bf16 and
        the mask fp32, so the bias is fp32; the JAX package's ``_attend``
        (:143) casts it to the scores' bf16, where the mask's -1e9 swamps
        the rel scores of a masked key all the same. Returns (out, the new
        cache {"k", "v"})."""
        d, h, g = self.dim_model, self.num_heads, self.group_size
        dh = g * d // h
        t_in = x.shape[1]
        th = hidden["k"].shape[1] if hidden is not None else 0
        q, k, v, new_hidden = self._project(x, hidden, th % g)
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
            window = P.grouped_relative_encoding(t, d, g, self.causal, x.device,
                                                 hidden_len=k.shape[1] - t)
        else:
            qu, qv = A.split_heads(q + u, h), A.split_heads(q + vb, h)
            kh, vh = A.split_heads(k, h), A.split_heads(v, h)
            window = P.relative_encoding(t_in, d, self.causal, x.device,
                                         hidden_len=k.shape[1] - t_in)
        e = self.pos_layer(window.to(x.dtype))
        rel = torch.einsum("bhqd,lhd->bhql", qv, e.reshape(-1, h, dh))
        skew = A.rel_to_abs_causal if self.causal else A.rel_to_abs_full
        bias = skew(rel) / math.sqrt(dh)
        if mask is not None:
            bias = bias + mask * A.NEG_INF
        o, _ = BA.bias_attention(qu, kh, vh, bias, 1.0 / math.sqrt(dh))
        # ungroup_time is merge_heads when G = 1
        return self.output_layer(A.ungroup_time(o, d)[:, :t_in]), new_hidden

    def _strided(self, x, mask, hidden=None):
        """Strided rel-pos attention (attentions.py:380-417): the queries of
        every S-th frame against every key, skewed by rel_to_abs_strided_*,
        on the bias attention at Nq = ceil(T/S) != Nk."""
        d, h, s = self.dim_model, self.num_heads, self.stride
        dh = d // h
        t_in = x.shape[1]
        q, k, v, new_hidden = self._project(x, hidden)
        qp, _ = M.pad_to_multiple(q, s)
        kp, _ = M.pad_to_multiple(k, s)
        vp, _ = M.pad_to_multiple(v, s)
        mask_p = M.pad_mask_to_multiple(mask, s)
        qs = qp[:, ::s]
        t_full = s * qs.shape[1]
        window = P.relative_encoding(t_full, d, self.causal, x.device,
                                     hidden_len=kp.shape[1] - t_full)
        e = self.pos_layer(window.to(x.dtype)).reshape(-1, h, dh)
        qu = A.split_heads(qs + self.u.to(x.dtype), h)
        qv = A.split_heads(qs + self.v.to(x.dtype), h)
        rel = torch.einsum("bhqd,lhd->bhql", qv, e)
        skew = A.rel_to_abs_strided_causal if self.causal else A.rel_to_abs_strided_full
        bias = skew(rel, s) / math.sqrt(dh)
        if mask_p is not None:
            bias = bias + mask_p[:, :, ::s] * A.NEG_INF
        o, _ = BA.bias_attention(qu, A.split_heads(kp, h), A.split_heads(vp, h), bias,
                                 1.0 / math.sqrt(dh))
        return self.output_layer(A.merge_heads(o)[:, :-(-t_in // s)]), new_hidden

    def _local(self, x, mask):
        """Local attention, rel-pos or absolute, strided or not
        (attentions.py:351-379, :418-447, :534-562): blocks of K frames,
        each attended by its own queries (every S-th in a strided layer),
        in plain PyTorch."""
        d, h, kw, s = self.dim_model, self.num_heads, self.kernel_size, self.stride
        dh = d // h
        t_in = x.shape[1]
        q = self.query_layer(x)
        k = self.key_layer(x)
        v = self.value_layer(x)
        qp, _ = M.pad_to_multiple(q, kw)
        kp, _ = M.pad_to_multiple(k, kw)
        vp, _ = M.pad_to_multiple(v, kw)
        mask_p = M.ensure_kv_mask(mask, t_in, kw, x.device)
        qs = qp[:, ::s] if s > 1 else qp
        kb, vb = A.split_blocks(kp, kw, h), A.split_blocks(vp, kw, h)
        if self.relative_pos_enc:
            window = P.relative_encoding(kw, d, self.causal, x.device)
            e = self.pos_layer(window.to(x.dtype)).reshape(-1, h, dh)
            qu = A.split_blocks(qs + self.u.to(x.dtype), kw // s, h)
            qv = A.split_heads(qs + self.v.to(x.dtype), h)
            rel = torch.einsum("bhtd,lhd->bhtl", qv, e)
            if s > 1:
                skew = (A.rel_to_abs_strided_local_causal if self.causal
                        else A.rel_to_abs_strided_local_full)
                att_e = skew(rel, kw, s)
            else:
                skew = A.rel_to_abs_local_causal if self.causal else A.rel_to_abs_local_full
                att_e = skew(rel, kw)
            scores = (qu @ kb.transpose(-1, -2) + att_e) / math.sqrt(dh)
        else:
            qb = A.split_blocks(qs, kw // s, h)
            scores = qb @ kb.transpose(-1, -2) / math.sqrt(dh)
        if mask_p is not None:
            mblk = M.local_block_diagonal(mask_p, kw)
            scores = scores + (mblk[:, :, :, ::s] if s > 1 else mblk) * A.NEG_INF
        o, _ = A.softmax_attention(scores, vb)
        return self.output_layer(A.merge_blocks(o, d)[:, :-(-t_in // s)])

    def _absolute(self, x, mask, hidden=None, cached=False):
        """Absolute attention, grouped, strided or plain (attentions.py
        :522-579), on the bias attention with the mask as the bias. Returns
        the output, or (output, the new cache) when ``cached``."""
        d, h, g, s = self.dim_model, self.num_heads, self.group_size, self.stride
        t_in = x.shape[1]
        q, k, v, new_hidden = self._project(x, hidden)
        if g > 1:
            qp, _ = M.pad_to_multiple(q, g)
            kp, _ = M.pad_to_multiple(k, g)
            vp, _ = M.pad_to_multiple(v, g)
            mask_p = M.pad_mask_to_multiple(mask, g)
            dh = g * d // h
            bias = mask_p[:, :, ::g, ::g] * A.NEG_INF if mask_p is not None else None
            o, _ = BA.bias_attention(A.group_time(qp, h, g), A.group_time(kp, h, g),
                                     A.group_time(vp, h, g), bias, 1.0 / math.sqrt(dh))
            o = A.ungroup_time(o, d)[:, :t_in]
        else:
            dh = d // h
            if s > 1:
                q = q[:, ::s]
                mask = mask[:, :, ::s] if mask is not None else None
            bias = mask * A.NEG_INF if mask is not None else None
            o, _ = BA.bias_attention(A.split_heads(q, h), A.split_heads(k, h),
                                     A.split_heads(v, h), bias, 1.0 / math.sqrt(dh))
            o = A.merge_heads(o)
        out = self.output_layer(o)
        return (out, new_hidden) if cached else out

    def _linear(self, x):
        """Linear attention (attentions.py:229-241): softmax over the
        features of q / dh^(1/4), times softmax over time of k / dh^(1/4)
        transposed against v; no mask, as the JAX module's."""
        h = self.num_heads
        scale = (self.dim_model // h) ** 0.25
        qh = A.split_heads(self.query_layer(x), h)
        kh = A.split_heads(self.key_layer(x), h)
        vh = A.split_heads(self.value_layer(x), h)
        kv = torch.einsum("bhtd,bhte->bhde", torch.softmax(kh / scale, dim=-2), vh)
        o = torch.einsum("bhtd,bhde->bhte", torch.softmax(qh / scale, dim=-1), kv)
        return self.output_layer(A.merge_heads(o))

    def step(self, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             at: "StepPositions") -> torch.Tensor:
        """One token through the causal layer on a fixed-capacity KV cache
        (attentions.py:177-227). x (B, 1, D); k and v (B, L, D) fp32 caches,
        into which the token's key and value are written in place, at the
        positions of ``at`` (nothing is written once a row's position
        reaches L, as XLA drops an out-of-bounds scatter); the token attends
        to slots 0..pos_b, the rel-pos score of slot j (of a rel-pos layer)
        taken at distance pos_b - j, with an fp32 softmax. Returns (B, 1, D)."""
        if not self.causal:
            raise ValueError("a KV-cache step of a non-causal layer")
        d, h = self.dim_model, self.num_heads
        dh = d // h
        b, cap = k.shape[:2]
        q = self.query_layer(x)[:, 0]
        for cache, layer in ((k, self.key_layer), (v, self.value_layer)):
            new = layer(x)[:, 0].to(cache.dtype)
            cache[at.rows, at.at] = torch.where(at.inside, new, cache[at.rows, at.at])
        if self.relative_pos_enc:
            qu = (q + self.u.to(x.dtype)).reshape(b, h, dh)
            qv = (q + self.v.to(x.dtype)).reshape(b, h, dh)
            scores = torch.einsum("bhd,bjhd->bhj", qu, k.view(b, cap, h, dh).to(x.dtype))
            rel = torch.einsum("bhd,lhd->bhl", qv, self._rel_table(cap, x.dtype, x.device))
            scores = scores + rel.gather(-1, at.rel_idx[:, None, :].expand(b, h, cap))
        else:
            scores = torch.einsum("bhd,bjhd->bhj", q.reshape(b, h, dh),
                                  k.view(b, cap, h, dh).to(x.dtype))
        scores = (scores / math.sqrt(dh)).masked_fill(at.invalid, A.NEG_INF)
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
