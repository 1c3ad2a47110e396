"""Prediction networks and LM decoders.

Counterpart of efficientconformer_tpu/models/decoders.py: the RNN (every
shipped Transducer config and LM-RNN), the Transformer (LM-Transformer) and
the Conformer decoder.
Two entry points, as the JAX package's:
  * ``forward(y, y_len)``: the teacher-forced pass over a whole label
    sequence, cast to the compute dtype after the embedding
    (``_compute_cast``, decoders.py:28-35);
  * ``step(y_t, carry)``: one token with an explicit carry, for the decode
    loops and the beam searches, which stay fp32 whatever the compute dtype,
    as in the JAX package. The RNN's carry is (h, c), each (num_layers, B,
    H); the Transformer's is either a fixed-capacity KV cache
    (``init_carry_fixed``, decoders.py:114-154) with per-row positions, so
    beam slots of different lengths share a batch: {"k": (B, blocks, L,
    D), "v": (B, blocks, L, D), "pos": (B,)}, the JAX package's per-block
    caches stacked (every block's position is the same), so a beam moves
    one tensor, not one a block; or the growing cache (decoders.py
    :114-137) of the host Transducer beam: None before the first token,
    then a tuple of one {"k": (B, t, D), "v": (B, t, D)} a block, which
    each step extends by ``torch.cat``, so hypotheses share their caches.
    The Conformer decoder (decoders.py:136-201; the JAX package has no
    step of its own) steps one token through its causal blocks on
    fixed-capacity caches, with no read back to the host: (k (blocks, B,
    L·D), v likewise, the depthwise convs' last K-1 inputs (blocks, B,
    D·(K-1)), positions (1, B, 1)), L the capacity (``max_tokens`` of
    ``init_carry``, the decode loop's token cap + 1), the batch on axis 1
    as the RNN's (h, c), so the greedy loops, the server and both beams
    select and gather it alike.
With ``vn_std`` the Transformer and Conformer decoders' blocks carry
variational noise (their embedding does not), as the JAX decoders'.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from efficientconformer_torch.config import BlockConfig
from efficientconformer_torch.models.attentions import step_positions
from efficientconformer_torch.models.blocks import ConformerBlock, TransformerBlock
from efficientconformer_torch.models.layers import LSTM, Dropout, Embedding
from efficientconformer_torch.ops.masks import streaming_mask
from efficientconformer_torch.ops.pos_enc import absolute_encoding, absolute_encoding_at


class RnnDecoder(nn.Module):
    """Embedding (id 0 embeds to zeros) + unidirectional LSTM stack
    (decoders.py:38-70)."""

    def __init__(self, params: dict, vn_std: Optional[float] = None):
        super().__init__()
        p = params
        self.embedding = Embedding(p["vocab_size"], p["dim_model"], vn_std=vn_std)
        self.rnn = LSTM(p["dim_model"], p["dim_model"], p["num_layers"], vn_std=vn_std)
        dtype = p.get("compute_dtype")
        self.compute_dtype = getattr(torch, dtype) if dtype else None

    def forward(self, y: torch.Tensor, y_len: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """y (B, U) int -> (B, U, D) in the compute dtype. It has no dropout,
        so it takes no generator."""
        e = self.embedding(y)
        if self.compute_dtype is not None:
            e = e.to(self.compute_dtype)
        out, _ = self.rnn(e)
        return out

    def step(self, y_t: torch.Tensor, carry):
        """y_t (B,) int -> ((B, D), new carry), in the carry's dtype."""
        out, carry = self.rnn(self.embedding(y_t[:, None]).to(carry[0].dtype), carry)
        return out[:, 0], carry

    def init_carry(self, batch: int, device, max_tokens: Optional[int] = None):
        return self.rnn.init_carry(batch, device)


class TransformerDecoder(nn.Module):
    """Embedding (id 0 embeds to zeros) + dropout + (the absolute encoding
    without rel-pos) + causal Transformer blocks (decoders.py:73-112), the
    LM-Transformer's decoder."""

    def __init__(self, params: dict, vn_std: Optional[float] = None):
        super().__init__()
        p = self.params = params
        self.embedding = Embedding(p["vocab_size"], p["dim_model"])
        self.dropout = Dropout(p["Pdrop"])
        self.blocks = nn.ModuleList(
            TransformerBlock(p["dim_model"], p["ff_ratio"], p["num_heads"], p["Pdrop"],
                             p["relative_pos_enc"], vn_std)
            for _ in range(p["num_blocks"]))
        dtype = p.get("compute_dtype")
        self.compute_dtype = getattr(torch, dtype) if dtype else None

    def forward(self, y: torch.Tensor, y_len: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """y (B, U) int -> (B, U, D) in the compute dtype. The mask is
        causal, reaches back ``left_context`` (default max_pos_encoding)
        tokens and hides the keys past y_len. In training mode the dropouts
        draw from ``generator``."""
        p = self.params
        t = y.shape[1]
        if y_len is not None:     # a trainer keeps the lengths on the host
            y_len = y_len.to(y.device, non_blocking=True)
        mask = streaming_mask(t, y_len, p.get("left_context", p["max_pos_encoding"]), 0,
                              device=y.device)
        x = self.embedding(y)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        x = self.dropout(x, generator)
        if not p["relative_pos_enc"]:
            x = x + absolute_encoding(t, p["dim_model"], y.device).to(x.dtype)
        for block in self.blocks:
            x, _ = block(x, mask, generator)
        return x

    def _position(self, x, pos):
        """x plus the absolute encoding of positions ``pos`` (B,) when the
        blocks have no rel-pos encodings."""
        if self.params["relative_pos_enc"]:
            return x
        return x + absolute_encoding_at(pos, self.params["dim_model"])[:, None].to(x.dtype)

    def step(self, y_t: torch.Tensor, carry):
        """y_t (B,) int -> ((B, D), new carry), in fp32 (no compute cast),
        in eval mode: on the growing cache when ``carry`` is None or a tuple
        of per-block {"k", "v"}, on the fixed-capacity cache of
        ``init_carry_fixed`` when it is that dict."""
        if carry is None or isinstance(carry, tuple):
            t = carry[0]["k"].shape[1] if carry is not None else 0
            x = self._position(self.embedding(y_t[:, None]),
                               torch.full_like(y_t, t))
            new_carry = []
            for i, block in enumerate(self.blocks):
                x, hidden = block(x, None, None, carry[i] if carry is not None else None)
                new_carry.append(hidden)
            return x[:, 0], tuple(new_carry)
        k, v, pos = carry["k"].clone(), carry["v"].clone(), carry["pos"]
        at = step_positions(pos, k.shape[2])
        x = self._position(self.embedding(y_t[:, None]), pos)
        for i, block in enumerate(self.blocks):
            x = block.step(x, k[:, i], v[:, i], at)
        return x[:, 0], {"k": k, "v": v, "pos": pos + 1}

    def init_carry_fixed(self, batch: int, max_len: int, device) -> dict:
        """An empty fp32 cache of ``max_len`` slots for every block, at
        position 0."""
        shape = (batch, len(self.blocks), max_len, self.params["dim_model"])
        return {"k": torch.zeros(shape, device=device), "v": torch.zeros(shape, device=device),
                "pos": torch.zeros((batch,), dtype=torch.long, device=device)}


class ConformerDecoder(nn.Module):
    """Embedding (id 0 embeds to zeros) + dropout + (the absolute encoding
    without rel-pos) + causal Conformer blocks under the causal window mask
    (decoders.py:157-200)."""

    def __init__(self, params: dict, vn_std: Optional[float] = None):
        super().__init__()
        p = self.params = params
        cfg = BlockConfig(
            block_id=0, dim_model=p["dim_model"], dim_expand=p["dim_model"],
            ff_ratio=p["ff_ratio"], num_heads=p["num_heads"], kernel_size=p["kernel_size"],
            att_group_size=1, att_kernel_size=None, linear_att=False, dropout=p["Pdrop"],
            relative_pos_enc=p["relative_pos_enc"], max_pos_encoding=p["max_pos_encoding"],
            conv_stride=1, att_stride=1, causal=True)
        self.embedding = Embedding(p["vocab_size"], p["dim_model"])
        self.dropout = Dropout(p["Pdrop"])
        self.blocks = nn.ModuleList(ConformerBlock(cfg, vn_std) for _ in range(p["num_blocks"]))
        dtype = p.get("compute_dtype")
        self.compute_dtype = getattr(torch, dtype) if dtype else None

    def forward(self, y: torch.Tensor, y_len: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """y (B, U) int -> (B, U, D) in the compute dtype. In training mode
        the dropouts draw from ``generator``."""
        p = self.params
        t = y.shape[1]
        if y_len is not None:     # a trainer keeps the lengths on the host
            y_len = y_len.to(y.device, non_blocking=True)
        mask = streaming_mask(t, y_len, p.get("left_context", p["max_pos_encoding"]), 0,
                              device=y.device)
        x = self.embedding(y)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        x = self.dropout(x, generator)
        if not p["relative_pos_enc"]:
            x = x + absolute_encoding(t, p["dim_model"], y.device).to(x.dtype)
        for block in self.blocks:
            x = block(x, mask, generator)
        return x

    def step(self, y_t: torch.Tensor, carry):
        """y_t (B,) int -> ((B, D) fp32, new carry), in eval mode: the token
        through each block at its row's position (ConformerBlock.step),
        attending to itself and the ``left_context`` tokens before it, as
        the forward's mask lets it. A row at capacity (never selected: the
        decode loops cap the tokens below it) writes no key."""
        p = self.params
        k, v, conv, pos = carry[0].clone(), carry[1].clone(), carry[2].clone(), carry[3][0, :, 0]
        nb, b = k.shape[:2]
        d = p["dim_model"]
        cap = k.shape[2] // d
        at = step_positions(pos, cap)
        slots = torch.arange(cap, device=pos.device)[None, :]
        left = p.get("left_context", p["max_pos_encoding"])
        at = at._replace(invalid=at.invalid | (slots < pos[:, None] - left)[:, None])
        x = self.embedding(y_t[:, None]).float()
        if not p["relative_pos_enc"]:
            x = x + absolute_encoding_at(pos, d)[:, None]
        k4, v4, c4 = k.view(nb, b, cap, d), v.view(nb, b, cap, d), conv.view(nb, b, d, -1)
        for i, block in enumerate(self.blocks):
            x, c4[i] = block.step(x, k4[i], v4[i], c4[i], at)
        return x[:, 0], (k, v, conv, (pos + 1)[None, :, None])

    def init_carry(self, batch: int, device, max_tokens: Optional[int] = None):
        """Empty fp32 caches of ``max_tokens`` slots (the blank and the
        tokens a decode loop may emit; max_pos_encoding by default), at
        position 0."""
        p = self.params
        cap = max_tokens if max_tokens is not None else p["max_pos_encoding"]
        nb, d = len(self.blocks), p["dim_model"]
        kv = torch.zeros((nb, batch, cap * d), device=device)
        conv = torch.zeros((nb, batch, d * (p["kernel_size"] - 1)), device=device)
        return kv, kv.clone(), conv, torch.zeros((1, batch, 1), dtype=torch.long, device=device)


def make_decoder(params: dict, vn_std: Optional[float] = None):
    arch = params["arch"]
    if arch == "RNN":
        return RnnDecoder(params, vn_std)
    if arch == "Transformer":
        return TransformerDecoder(params, vn_std)
    if arch == "Conformer":
        return ConformerDecoder(params, vn_std)
    raise ValueError(f"unknown decoder arch {arch!r}")
