"""Prediction networks and LM decoders.

Counterpart of efficientconformer_tpu/models/decoders.py for the RNN (every
shipped Transducer config and LM-RNN) and the Transformer (LM-Transformer).
Two entry points, as the JAX package's:
  * ``forward(y, y_len)``: the teacher-forced pass over a whole label
    sequence, cast to the compute dtype after the embedding
    (``_compute_cast``, decoders.py:28-35);
  * ``step(y_t, carry)``: one token with an explicit carry, for the decode
    loops and the beam searches, which stay fp32 whatever the compute dtype,
    as in the JAX package. The RNN's carry is (h, c), each (num_layers, B,
    H); the Transformer's is a fixed-capacity KV cache (``init_carry_fixed``,
    decoders.py:114-154) with per-row positions, so beam slots of
    different lengths share a batch: {"k": (B, blocks, L, D), "v": (B,
    blocks, L, D), "pos": (B,)}, the JAX package's per-block caches stacked
    (every block's position is the same), so a beam moves one tensor, not
    one a block. The growing cache (``step(y_t, None)``), which only the
    host Transducer beam needs, raises with its ROADMAP item.
The Conformer decoder raises with its ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from efficientconformer_torch.models.attentions import step_positions
from efficientconformer_torch.models.blocks import TransformerBlock
from efficientconformer_torch.models.layers import LSTM, Dropout, Embedding
from efficientconformer_torch.ops.masks import streaming_mask


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

    def init_carry(self, batch: int, device):
        return self.rnn.init_carry(batch, device)


class TransformerDecoder(nn.Module):
    """Embedding (id 0 embeds to zeros) + dropout + causal rel-pos
    Transformer blocks (decoders.py:73-112), the LM-Transformer's decoder."""

    def __init__(self, params: dict):
        super().__init__()
        p = self.params = params
        self.embedding = Embedding(p["vocab_size"], p["dim_model"])
        self.dropout = Dropout(p["Pdrop"])
        self.blocks = nn.ModuleList(
            TransformerBlock(p["dim_model"], p["ff_ratio"], p["num_heads"], p["Pdrop"],
                             p["relative_pos_enc"])
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
        mask = streaming_mask(t, y_len, p.get("left_context", p["max_pos_encoding"]), 0,
                              device=y.device)
        x = self.embedding(y)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        x = self.dropout(x, generator)
        for block in self.blocks:
            x = block(x, mask, generator)
        return x

    def step(self, y_t: torch.Tensor, carry):
        """y_t (B,) int -> ((B, D), new carry) on the fixed-capacity cache of
        ``init_carry_fixed``, in fp32 (no compute cast), in eval mode."""
        if carry is None:
            raise NotImplementedError(
                "the Transformer decoder's growing KV cache (the host Transducer beam's): "
                "ROADMAP Queue 1 item 11")
        k, v, pos = carry["k"].clone(), carry["v"].clone(), carry["pos"]
        at = step_positions(pos, k.shape[2])
        x = self.embedding(y_t[:, None])
        for i, block in enumerate(self.blocks):
            x = block.step(x, k[:, i], v[:, i], at)
        return x[:, 0], {"k": k, "v": v, "pos": pos + 1}

    def init_carry_fixed(self, batch: int, max_len: int, device) -> dict:
        """An empty fp32 cache of ``max_len`` slots for every block, at
        position 0."""
        shape = (batch, len(self.blocks), max_len, self.params["dim_model"])
        return {"k": torch.zeros(shape, device=device), "v": torch.zeros(shape, device=device),
                "pos": torch.zeros((batch,), dtype=torch.long, device=device)}


def make_decoder(params: dict, vn_std: Optional[float] = None):
    arch = params["arch"]
    if arch == "RNN":
        return RnnDecoder(params, vn_std)
    if arch == "Transformer" and vn_std is None:
        return TransformerDecoder(params)
    raise NotImplementedError(
        f"{arch} decoder{' with variational noise' if vn_std is not None else ''}: ROADMAP "
        "Queue 1 items 10-11 (no shipped config uses it)")
