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

Under tensor parallelism (``shard_``, from parallel/tensor.shard_model_)
the query, key and value projections are column-parallel and the output
projection row-parallel over the model group; the input enters the group
once. A layer whose width the model size does not divide runs replicated,
as the JAX package's does. Where a rank's columns are whole heads (G = 1 and
H divisible by the model size) the factorized, skewing, local and linear
paths and the one-token step run on the rank's H/n heads, each rank taking
its slices of u and v, and of the per-head pos weights (delta and W, or the
pos projection's window) through ``scatter_features``, whose backward
gathers the gradients whole; a KV cache then holds the rank's columns.
Elsewhere (grouped layers, whose heads fold G frames across the column
split, any H the model size does not divide, the strided and absolute
paths) the gather path: q, k and v are gathered along the features, every
head-indexed input of the kernel (or of the plain local and linear
attention) is cut to the rank's heads (zero heads pad an uneven split), it
runs on them, the heads' output is gathered and the rank's feature slice
goes to the output projection; a KV cache then holds the whole width, and
the one-token step runs every head.

Under sequence parallelism (a ``span``, parallel/sequence.py) each rank
projects its own frames and computes its own rows, the keys and values
gathered whole along time: the factorized path runs the kernel on the
rank's query rows from its row offset in the position tables; the skewing
path (causal, even G, a full (T, T) mask), the strided and the absolute
paths run the bias kernel on them (Nq < Nk), the rel scores skewed for
those rows alone (``ops/attention.rel_to_abs_rows``) and the mask's rows
sliced; a strided layer's rows are the rank's frames at multiples of S. A
grouped layer gathers the queries too and computes the groups that cover
the rank's frames (a group straddling two ranks is computed on both). Local
attention takes a halo of K - 1 frames of q, k and v from each neighbour
and computes the blocks that cover the rank's frames; linear attention sums
its softmax over time and k^T v over the seq group
(``sequence.softmax_time_product``).

Parameter names are the original PyTorch repo's (query_layer, key_layer,
value_layer, output_layer, and for rel-pos pos_layer, u, v), so
utils/weights.py maps them. With ``vn_std`` the query, key, value and
output projections carry variational noise (models/layers.py), as the JAX
module's Dense layers do; the pos projection does not.
"""

from __future__ import annotations

import functools
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
from efficientconformer_torch.parallel import sequence
from efficientconformer_torch.parallel import tensor as tp_ops


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
        self.tp = None               # the model group under tensor parallelism

    def shard_(self, reg, placement: dict, name: str) -> None:
        """This layer's tensor-parallel form over the model group ``reg``
        (parallel/tensor.shard_model_, which then cuts the weights by
        ``placement``)."""
        layers = (self.query_layer, self.key_layer, self.value_layer, self.output_layer)
        kinds = [placement[f"{name}.{lname}.weight"].kind
                 for lname in ("query_layer", "key_layer", "value_layer", "output_layer")]
        if kinds != ["column"] * 3 + ["row"]:
            return       # a width the model size does not divide: replicated, as in JAX
        for layer, mode in zip(layers, ("column",) * 3 + ("row",)):
            layer.tp, layer.tp_mode = reg, mode
        self.tp = reg

    def _whole_heads(self) -> bool:
        """Whether a rank's columns are whole heads (the kernel then runs on
        them as they come, with no gather)."""
        return (self.tp is not None and self.group_size == 1
                and self.num_heads % self.tp.size == 0)

    def _qkv(self, x, whole: bool):
        """q, k and v of x: whole, this rank's columns (``whole``), or, on
        the gather path, this rank's columns gathered whole."""
        q, k, v = self.query_layer(x), self.key_layer(x), self.value_layer(x)
        if self.tp is None or whole:
            return q, k, v
        return tuple(tp_ops.gather_features(t, self.tp) for t in (q, k, v))

    def _uv(self, whole: bool):
        """(u, v): this rank's slices when its columns are whole heads."""
        if not whole:
            return self.u, self.v
        uv = tp_ops.scatter_features(torch.stack([self.u, self.v]), self.tp)
        return uv[0], uv[1]

    def _own_heads(self, t, dim: int, whole: bool):
        """A replicated per-head tensor cut to this rank's heads (along
        ``dim``) when its columns are whole heads."""
        return tp_ops.scatter_features(t, self.tp, dim) if whole else t

    def _attend(self, fn, args, head_dims, whole: bool):
        """o (B, H, N, dh) of ``fn(*args)`` (a kernel returning (o, lse)).
        On the gather path each argument with a head dim (``head_dims``,
        None for none; the first argument's names the output's) of the H
        heads is cut to this rank's heads, padded with zero heads to a
        multiple of the model size, and the heads' outputs are gathered."""
        if self.tp is None or whole:
            return fn(*args)[0]
        reg, hd = self.tp, head_dims[0]
        h = args[0].shape[hd]
        hp = -(-h // reg.size) * reg.size
        mine = []
        for a, d in zip(args, head_dims):
            if d is not None and torch.is_tensor(a) and a.shape[d] == h:
                if hp != h:
                    pad = [0, 0] * (a.dim() - 1 - d) + [0, hp - h]
                    a = torch.nn.functional.pad(a, pad)
                a = tp_ops.scatter_features(a, reg, d)
            mine.append(a)
        return tp_ops.gather_features(fn(*mine)[0], reg, hd).narrow(hd, 0, h)

    def _out(self, o, whole: bool):
        """The output projection of o (B, T, D), or of this rank's columns
        when they are whole heads: on the gather path the rank's feature
        slice enters the row-parallel projection."""
        if self.tp is not None and not whole:
            o = tp_ops.scatter_features(o, self.tp)
        return self.output_layer(o)

    def init_rel_biases_(self, generator: torch.Generator) -> None:
        """u and v: Xavier-uniform over (H, G*D/H), as the JAX package."""
        if not self.relative_pos_enc:
            return
        dim_head = self.group_size * self.dim_model // self.num_heads
        bound = math.sqrt(6.0 / (self.num_heads + dim_head))
        with torch.no_grad():
            self.u.uniform_(-bound, bound, generator=generator)
            self.v.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                span=None) -> torch.Tensor:
        """x (B, T, D) -> (B, T, D), or (B, ceil(T/S), D) in a strided layer;
        mask (B or 1, 1, 1, T) with 1.0 at padded keys, a full (B or 1, 1,
        T, T) mask with 1.0 where query i may not see key j, or None. Under
        sequence parallelism x holds this rank's frames ``span``
        (parallel/sequence.Span) of a sequence that the mask covers whole,
        and the output the rank's rows (``sequence.strided(span, S)`` in a
        strided layer)."""
        if self.tp is not None:
            x = tp_ops.copy_to_region(x, self.tp)
        if self.linear_att:
            return self._linear(x, span)
        if self.kernel_size is not None:
            return self._local(x, mask, span)
        if not self.relative_pos_enc:
            return self._absolute(x, mask, span=span)
        if self.stride > 1:
            return self._strided(x, mask, span=span)[0]
        if not self._factorizes(mask):
            return self._skewed(x, mask, span=span)[0]
        return self._factorized(x, mask, span)

    def _factorizes(self, mask) -> bool:
        """Whether a full-sequence call takes the fused rel-pos attention:
        rel-pos, odd G, non-causal, a key-only mask, not local, strided or
        linear."""
        return (self.relative_pos_enc and not self.linear_att and self.kernel_size is None
                and self.stride == 1 and not self.causal and self.group_size % 2 == 1
                and (mask is None or mask.shape[-2] == 1))

    def _factorized(self, x, mask, span=None):
        """The fused rel-pos attention (odd G, non-causal, key-only mask).
        Under sequence parallelism (``span``) the keys and values are
        gathered whole along time, and the rank's own query rows attend to
        them: the position table's rows from the rank's first row on. In a
        grouped layer the queries are gathered too and the rank takes the
        groups that cover its frames (a group may straddle two ranks: both
        compute it and each keeps its frames)."""
        d, h, g = self.dim_model, self.num_heads, self.group_size
        t_in = x.shape[1]
        whole = self._whole_heads()
        q, k, v = self._qkv(x, whole)
        rows = None                       # the grouped rows this rank computes
        if span is not None:
            width = q.shape[-1]
            if g > 1:
                q, k, v = sequence.gather_time(torch.cat([q, k, v], -1), span.seq).split(
                    width, -1)
                rows = sequence.covering(span, g)
            else:
                k, v = sequence.gather_time(torch.cat([k, v], -1), span.seq).split(width, -1)
        u_p, v_p = self._uv(whole)
        u = u_p.to(x.dtype)
        # the pos layer's (D_in, D_out) kernel; its bias cancels in the softmax
        pos_kernel = self.pos_layer.weight.T.to(torch.float32)
        vu = (v_p - u_p).to(torch.float32)

        if g > 1:
            qp, _ = M.pad_to_multiple(q, g)
            kp, _ = M.pad_to_multiple(k, g)
            vp, _ = M.pad_to_multiple(v, g)
            mask_p = M.pad_mask_to_multiple(mask, g)
            dh = g * d // h
            if rows is not None:
                qp = qp[:, rows[0] * g:rows[1] * g]
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
            hl = h // self.tp.size if whole else h      # this rank's heads
            qu = A.split_heads(q + u, hl)
            kh = A.split_heads(k, hl)
            vh = A.split_heads(v, hl)
            bias = mask * A.NEG_INF if mask is not None else None
            delta = vu.reshape(hl, dh)
            w_h = self._own_heads(RF.rel_w_plain(pos_kernel, h, d // 2), 0, whole)

        if span is None:
            rowtab, keytab = RF.rel_tables(qu.shape[2], kh.shape[2], d, g, x.device)
        else:
            # the whole sequence's tables; the rank's rows start at its first
            # (grouped: its first covering group's) position
            rowtab, keytab = RF.rel_tables(kh.shape[2], kh.shape[2], d, g, x.device)
            r0 = rows[0] if rows is not None else span.start
            rowtab = rowtab[r0:r0 + qu.shape[2]]
        o = self._attend(RA.relpos_attention, (qu, kh, vh, delta, w_h, rowtab, keytab, bias,
                                               1.0 / math.sqrt(dh)),
                         (1, 1, 1, 0, 0, None, None, 1, None), whole)
        # ungroup_time is merge_heads when G = 1
        o = A.ungroup_time(o, q.shape[-1])
        if rows is not None:
            o = o[:, span.start - rows[0] * g:]
        return self._out(o[:, :t_in], whole)

    def forward_cached(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                       hidden: Optional[dict]):
        """x (B, T, D) attends to the cached keys and values of ``hidden``
        ({"k", "v"}, each (B, Th, D), or None for none) followed by its own;
        ``mask``, if given, is (B or 1, 1, T, Th' + T), Th' the cached frames
        attended. Plain, grouped and strided rel-pos layers and plain
        absolute ones. Returns (out, the new cache {"k", "v"} of (B, Th + T,
        D)). Under tensor parallelism the cache holds the rank's columns
        where they are whole heads (G = 1 on the skewing path), the whole
        width on the gather path."""
        if self.linear_att or self.kernel_size is not None:
            raise ValueError("a KV cache of local or linear attention")
        if self.tp is not None:
            x = tp_ops.copy_to_region(x, self.tp)
        if not self.relative_pos_enc:
            if self.group_size > 1 or self.stride > 1:
                raise ValueError("a KV cache of grouped or strided absolute attention")
            return self._absolute(x, mask, hidden, cached=True)
        if self.stride > 1:
            return self._strided(x, mask, hidden)
        return self._skewed(x, mask, hidden)

    def _project(self, x, hidden, keep_from: int = 0, whole: bool = False):
        """q, k and v of x (``_qkv``), the cached keys and values from
        ``keep_from`` on prepended to k and v, and the new cache (all of the
        old one and x's)."""
        q, k, v = self._qkv(x, whole)
        if hidden is None:
            return q, k, v, {"k": k, "v": v}
        new_hidden = {"k": torch.cat([hidden["k"], k], dim=1),
                      "v": torch.cat([hidden["v"], v], dim=1)}
        if keep_from == 0:
            return q, new_hidden["k"], new_hidden["v"], new_hidden
        return (q, torch.cat([hidden["k"][:, keep_from:], k], dim=1),
                torch.cat([hidden["v"][:, keep_from:], v], dim=1), new_hidden)

    def _time_shared(self, q, k, v, span, group: int = 1, whole_q: bool = False):
        """Under sequence parallelism (``span``): k and v gathered whole
        along time, and q too where the rows are groups of ``group`` > 1
        frames (a group may straddle two ranks) or with ``whole_q`` (a
        causal layer's skew reads the row after the rank's); (q, k, v, the
        rows this rank computes: its frames, or the groups that cover them).
        Without a span, as they are and None."""
        if span is None:
            return q, k, v, None
        width = q.shape[-1]
        rows = (span.start, span.start + span.length)
        if group > 1 or whole_q:
            q, k, v = sequence.gather_time(torch.cat([q, k, v], -1), span.seq).split(width, -1)
            return q, k, v, sequence.covering(span, group) if group > 1 else rows
        k, v = sequence.gather_time(torch.cat([k, v], -1), span.seq).split(width, -1)
        return q, k, v, rows

    @staticmethod
    def _mask_rows(mask, rows, step: int = 1):
        """A mask's query rows ``rows`` (of its rows every ``step``-th): a
        full (T, T) mask's, or a key-only mask as it is."""
        if mask is None:
            return None
        if step > 1:
            mask = mask[:, :, ::step]
        if rows is None or mask.shape[-2] == 1:
            return mask
        return mask[:, :, rows[0]:rows[1]]

    def _skewed(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                hidden: Optional[dict] = None, span=None):
        """The Transformer-XL skewing path (attentions.py:249-348 grouped,
        :448-518 plain): qu = q + u attends to the keys under the bias
        rel_to_abs(qv . e) / sqrt(dh) + mask * NEG_INF, with qv = q + v and
        e the pos projection of the relative window, which reaches back over
        the cached keys of ``hidden``. In bf16 the rel scores are bf16 and
        the mask fp32, so the bias is fp32; the JAX package's ``_attend``
        (:143) casts it to the scores' bf16, where the mask's -1e9 swamps
        the rel scores of a masked key all the same. Under sequence
        parallelism (``span``) the rank's rows (its frames, or in a grouped
        layer the groups that cover them) attend to the gathered keys, their
        rel scores skewed at the rows' offset (``rel_to_abs_rows``; a causal
        layer gathers q too, as its skew reads the next row's scores past a
        row's window) and the mask's rows sliced. Returns (out, the new
        cache {"k", "v"})."""
        d, h, g = self.dim_model, self.num_heads, self.group_size
        dh = g * d // h
        t_in = x.shape[1]
        th = hidden["k"].shape[1] if hidden is not None else 0
        whole = self._whole_heads()
        q, k, v, new_hidden = self._project(x, hidden, th % g, whole)
        q, k, v, rows = self._time_shared(q, k, v, span, g, whole_q=self.causal)
        u, vb = (t.to(x.dtype) for t in self._uv(whole))
        hl = h // self.tp.size if whole else h          # this rank's heads
        # the rows' own frames (qu), and for qv in a causal layer the next row's too
        after = g * self.causal
        if g > 1:
            q, _ = M.pad_to_multiple(q, g)
            k, _ = M.pad_to_multiple(k, g)
            v, _ = M.pad_to_multiple(v, g)
            mask = M.pad_mask_to_multiple(mask, g)
            if mask is not None:
                mask = mask[:, :, ::g, ::g]
            t = q.shape[1]
            qv_frames = q
            if rows is not None:
                qv_frames = q[:, rows[0] * g:rows[1] * g + after]
                q = q[:, rows[0] * g:rows[1] * g]
            qu, qv = A.group_time(q + u, h, g), A.group_time(qv_frames + vb, h, g)
            kh, vh = A.group_time(k, h, g), A.group_time(v, h, g)
            window = P.grouped_relative_encoding(t, d, g, self.causal, x.device,
                                                 hidden_len=k.shape[1] - t)
        else:
            qv_frames = q
            if rows is not None and self.causal:     # q gathered whole
                qv_frames = q[:, rows[0]:rows[1] + after]
                q = q[:, rows[0]:rows[1]]
            qu, qv = A.split_heads(q + u, hl), A.split_heads(qv_frames + vb, hl)
            kh, vh = A.split_heads(k, hl), A.split_heads(v, hl)
            t = kh.shape[2] if span is not None else t_in
            window = P.relative_encoding(t, d, self.causal, x.device,
                                         hidden_len=k.shape[1] - t)
        e = self.pos_layer(window.to(x.dtype))
        e = self._own_heads(e.reshape(-1, h, dh), 1, whole)
        rel = torch.einsum("bhqd,lhd->bhql", qv, e)
        if rows is None:
            skew = A.rel_to_abs_causal if self.causal else A.rel_to_abs_full
            bias = skew(rel) / math.sqrt(dh)
        else:
            bias = A.rel_to_abs_rows(rel, rows[0], kh.shape[2], causal=self.causal,
                                     rows=rows[1] - rows[0]) / math.sqrt(dh)
        mask = self._mask_rows(mask, rows)
        if mask is not None:
            bias = bias + mask * A.NEG_INF
        o = self._attend(BA.bias_attention, (qu, kh, vh, bias, 1.0 / math.sqrt(dh)),
                         (1, 1, 1, 1, None), whole)
        # ungroup_time is merge_heads when G = 1
        o = A.ungroup_time(o, q.shape[-1])
        if span is not None:
            o = o[:, span.start - rows[0] * g:]
            t_in = span.length
        return self._out(o[:, :t_in], whole), new_hidden

    def _strided(self, x, mask, hidden=None, span=None):
        """Strided rel-pos attention (attentions.py:380-417): the queries of
        every S-th frame against every key, skewed by rel_to_abs_strided_*,
        on the bias attention at Nq = ceil(T/S) != Nk. Under sequence
        parallelism the rank's queries are those of its frames at multiples
        of S (``sequence.strided(span, S)``), against the gathered keys."""
        d, h, s = self.dim_model, self.num_heads, self.stride
        dh = d // h
        t_in = x.shape[1]
        q, k, v, new_hidden = self._project(x, hidden)
        q, k, v, _ = self._time_shared(q, k, v, span, whole_q=self.causal)
        kp, _ = M.pad_to_multiple(k, s)
        vp, _ = M.pad_to_multiple(v, s)
        mask_p = M.pad_mask_to_multiple(mask, s)
        rows = None
        if span is None:
            qs = qv_rows = M.pad_to_multiple(q, s)[0][:, ::s]
            t_full = s * qs.shape[1]
        else:
            out = sequence.strided(span, s)
            rows = (out.start, out.start + out.length)
            if self.causal:     # q gathered whole: the rows, and for qv the next one
                every = M.pad_to_multiple(q, s)[0][:, ::s]
                qs, qv_rows = every[:, rows[0]:rows[1]], every[:, rows[0]:rows[1] + 1]
            else:
                qs = qv_rows = q[:, out.start * s - span.start::s]
            t_full = kp.shape[1]
            t_in = out.length * s
        window = P.relative_encoding(t_full, d, self.causal, x.device,
                                     hidden_len=kp.shape[1] - t_full)
        e = self.pos_layer(window.to(x.dtype)).reshape(-1, h, dh)
        qu = A.split_heads(qs + self.u.to(x.dtype), h)
        qv = A.split_heads(qv_rows + self.v.to(x.dtype), h)
        rel = torch.einsum("bhqd,lhd->bhql", qv, e)
        if rows is None:
            skew = A.rel_to_abs_strided_causal if self.causal else A.rel_to_abs_strided_full
            bias = skew(rel, s) / math.sqrt(dh)
        else:
            bias = A.rel_to_abs_rows(rel, rows[0], t_full, s, causal=self.causal,
                                     rows=rows[1] - rows[0]) / math.sqrt(dh)
        mask_p = self._mask_rows(mask_p, rows, s)
        if mask_p is not None:
            bias = bias + mask_p * A.NEG_INF
        o = self._attend(BA.bias_attention, (qu, A.split_heads(kp, h), A.split_heads(vp, h),
                                             bias, 1.0 / math.sqrt(dh)),
                         (1, 1, 1, 1, None), False)
        return self._out(A.merge_heads(o)[:, :-(-t_in // s)], False), new_hidden

    def _local(self, x, mask, span=None):
        """Local attention, rel-pos or absolute, strided or not
        (attentions.py:351-379, :418-447, :534-562): blocks of K frames,
        each attended by its own queries (every S-th in a strided layer),
        in plain PyTorch, on the rank's heads under tensor parallelism (the
        gather path where they are not whole). Under sequence parallelism
        the rank takes a halo of K - 1 frames of q, k and v from each
        neighbour and computes the blocks that cover its frames, keeping its
        rows."""
        d, h, kw, s = self.dim_model, self.num_heads, self.kernel_size, self.stride
        dh = d // h
        whole = self._whole_heads()
        hl = h // self.tp.size if whole else h
        q, k, v = self._qkv(x, whole)
        width = q.shape[-1]
        t_in = x.shape[1] if span is None else span.total
        b0 = 0
        if span is None:
            q, k, v = (M.pad_to_multiple(t, kw)[0] for t in (q, k, v))
        else:
            b0, b1 = sequence.covering(span, kw)
            qkv = sequence.halo(torch.cat([q, k, v], -1), kw - 1, kw - 1, span.seq)
            at = b0 * kw - span.start + kw - 1
            q, k, v = qkv[:, at:at + (b1 - b0) * kw].split(width, -1)
        mask_p = M.ensure_kv_mask(mask, t_in, kw, x.device)
        qs = q[:, ::s] if s > 1 else q
        kb, vb = A.split_blocks(k, kw, hl), A.split_blocks(v, kw, hl)
        att_e = None
        if self.relative_pos_enc:
            u, vv = (t.to(x.dtype) for t in self._uv(whole))
            window = P.relative_encoding(kw, d, self.causal, x.device)
            e = self._own_heads(self.pos_layer(window.to(x.dtype)).reshape(-1, h, dh), 1, whole)
            qb = A.split_blocks(qs + u, kw // s, hl)
            rel = torch.einsum("bhtd,lhd->bhtl", A.split_heads(qs + vv, hl), e)
            if s > 1:
                skew = (A.rel_to_abs_strided_local_causal if self.causal
                        else A.rel_to_abs_strided_local_full)
                att_e = skew(rel, kw, s)
            else:
                skew = A.rel_to_abs_local_causal if self.causal else A.rel_to_abs_local_full
                att_e = skew(rel, kw)
        else:
            qb = A.split_blocks(qs, kw // s, hl)
        mblk = None
        if mask_p is not None:
            mblk = M.local_block_diagonal(mask_p, kw)[:, b0:b0 + kb.shape[1]]
            mblk = mblk[:, :, :, ::s] if s > 1 else mblk
        o = self._attend(functools.partial(_block_attention, dh), (qb, kb, vb, att_e, mblk),
                         (2, 2, 2, 2, None), whole)
        o = A.merge_blocks(o, width)
        if span is None:
            return self._out(o[:, :-(-t_in // s)], whole)
        out = sequence.strided(span, s)
        first = out.start - b0 * kw // s
        return self._out(o[:, first:first + out.length], whole)

    def _absolute(self, x, mask, hidden=None, cached=False, span=None):
        """Absolute attention, grouped, strided or plain (attentions.py
        :522-579), on the bias attention with the mask as the bias. Under
        sequence parallelism the rank's rows (its frames, its frames at
        multiples of S, or the groups that cover them) attend to the
        gathered keys. Returns the output, or (output, the new cache) when
        ``cached``."""
        d, h, g, s = self.dim_model, self.num_heads, self.group_size, self.stride
        t_in = x.shape[1]
        q, k, v, new_hidden = self._project(x, hidden)
        q, k, v, rows = self._time_shared(q, k, v, span, g)
        if g > 1:
            qp, _ = M.pad_to_multiple(q, g)
            kp, _ = M.pad_to_multiple(k, g)
            vp, _ = M.pad_to_multiple(v, g)
            mask_p = M.pad_mask_to_multiple(mask, g)
            dh = g * d // h
            mask_p = mask_p[:, :, ::g, ::g] if mask_p is not None else None
            mask_p = self._mask_rows(mask_p, rows)
            bias = mask_p * A.NEG_INF if mask_p is not None else None
            if rows is not None:
                qp = qp[:, rows[0] * g:rows[1] * g]
            o = self._attend(BA.bias_attention,
                             (A.group_time(qp, h, g), A.group_time(kp, h, g),
                              A.group_time(vp, h, g), bias, 1.0 / math.sqrt(dh)),
                             (1, 1, 1, 1, None), False)
            o = A.ungroup_time(o, d)
            o = o[:, :t_in] if span is None else o[:, span.start - rows[0] * g:][:, :t_in]
        else:
            dh = d // h
            if s > 1:
                first = 0
                if span is not None:
                    out = sequence.strided(span, s)
                    rows, first = (out.start, out.start + out.length), out.start * s - span.start
                q = q[:, first::s]
            mask = self._mask_rows(mask, rows, s)
            bias = mask * A.NEG_INF if mask is not None else None
            o = self._attend(BA.bias_attention,
                             (A.split_heads(q, h), A.split_heads(k, h), A.split_heads(v, h),
                              bias, 1.0 / math.sqrt(dh)), (1, 1, 1, 1, None), False)
            o = A.merge_heads(o)
        out = self._out(o, False)
        return (out, new_hidden) if cached else out

    def _linear(self, x, span=None):
        """Linear attention (attentions.py:229-241): softmax over the
        features of q / dh^(1/4), times softmax over time of k / dh^(1/4)
        transposed against v; no mask, as the JAX module's. On the rank's
        heads under tensor parallelism (the gather path where they are not
        whole); under sequence parallelism the softmax over time and k^T v
        are summed over the seq group (``sequence.softmax_time_product``)
        and the rank's queries take them."""
        h = self.num_heads
        whole = self._whole_heads()
        hl = h // self.tp.size if whole else h
        scale = (self.dim_model // h) ** 0.25
        heads = tuple(A.split_heads(t, hl) for t in self._qkv(x, whole))
        o = self._attend(functools.partial(_linear_attention, scale,
                                           span.seq if span is not None else None),
                         heads, (1, 1, 1), whole)
        return self._out(A.merge_heads(o), whole)

    def cache_width(self) -> int:
        """The feature width of this layer's fixed-capacity KV cache: the
        rank's columns under tensor parallelism where they are whole heads,
        else the whole width."""
        return self.dim_model // self.tp.size if self._whole_heads() else self.dim_model

    def step(self, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             at: "StepPositions") -> torch.Tensor:
        """One token through the causal layer on a fixed-capacity KV cache
        (attentions.py:177-227). x (B, 1, D); k and v (B, L, ``cache_width``)
        fp32 caches, into which the token's key and value are written in
        place, at the positions of ``at`` (nothing is written once a row's
        position reaches L, as XLA drops an out-of-bounds scatter); the token
        attends to slots 0..pos_b, the rel-pos score of slot j (of a rel-pos
        layer) taken at distance pos_b - j, with an fp32 softmax. Under
        tensor parallelism on the rank's heads where they are whole, else
        (the gather path) on every head, its output's feature slice entering
        the row-parallel output projection. Returns (B, 1, D)."""
        if not self.causal:
            raise ValueError("a KV-cache step of a non-causal layer")
        if self.tp is not None:
            x = tp_ops.copy_to_region(x, self.tp)
        whole = self._whole_heads()
        h = self.num_heads // self.tp.size if whole else self.num_heads
        dh = self.dim_model // self.num_heads
        b, cap, width = k.shape
        q, new_k, new_v = self._qkv(x, whole)
        q = q[:, 0]
        for cache, new in ((k, new_k), (v, new_v)):
            new = new[:, 0].to(cache.dtype)
            cache[at.rows, at.at] = torch.where(at.inside, new, cache[at.rows, at.at])
        if self.relative_pos_enc:
            u, vb = (t.to(x.dtype) for t in self._uv(whole))
            qu = (q + u).reshape(b, h, dh)
            qv = (q + vb).reshape(b, h, dh)
            table = self._own_heads(self._rel_table(cap, x.dtype, x.device), 1, whole)
            scores = torch.einsum("bhd,bjhd->bhj", qu, k.view(b, cap, h, dh).to(x.dtype))
            rel = torch.einsum("bhd,lhd->bhl", qv, table)
            scores = scores + rel.gather(-1, at.rel_idx[:, None, :].expand(b, h, cap))
        else:
            scores = torch.einsum("bhd,bjhd->bhj", q.reshape(b, h, dh),
                                  k.view(b, cap, h, dh).to(x.dtype))
        scores = (scores / math.sqrt(dh)).masked_fill(at.invalid, A.NEG_INF)
        p_att = torch.softmax(scores.to(torch.float32), dim=-1)
        o = torch.einsum("bhj,bjhd->bhd", p_att.to(v.dtype), v.view(b, cap, h, dh))
        return self._out(o.reshape(b, 1, width).to(x.dtype), whole)

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


def _block_attention(dh: int, qb, kb, vb, att_e, mblk):
    """Block-local attention (B, N, H, K', dh) of queries ``qb`` on the keys
    ``kb`` and values ``vb`` of their blocks, the rel-pos scores ``att_e``
    added (None for none) and the blocks' mask ``mblk`` (None for none):
    (o, None), as a kernel returns (o, lse)."""
    scores = qb @ kb.transpose(-1, -2)
    if att_e is not None:
        scores = scores + att_e
    scores = scores / math.sqrt(dh)
    if mblk is not None:
        scores = scores + mblk * A.NEG_INF
    return A.softmax_attention(scores, vb)[0], None


def _linear_attention(scale: float, seq, qh, kh, vh):
    """softmax(q / scale) (softmax_T(k / scale)^T v) of (B, H, T, dh) heads:
    (o, None); with a seq group ``seq`` the softmax over time and k^T v
    summed over its ranks' frames."""
    if seq is None:
        kv = torch.einsum("bhtd,bhte->bhde", torch.softmax(kh / scale, dim=-2), vh)
    else:
        kv = sequence.softmax_time_product(kh / scale, vh, seq)
    return torch.einsum("bhtd,bhde->bhte", torch.softmax(qh / scale, dim=-1), kv), None
