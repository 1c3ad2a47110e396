"""Prediction networks.

Counterpart of efficientconformer_tpu/models/decoders.py for the one decoder
every shipped Transducer config uses, the RNN. Two entry points, as the JAX
package's:
  * ``forward(y, y_len)``: the teacher-forced pass over a whole label
    sequence, cast to the compute dtype after the embedding
    (``_compute_cast``, decoders.py:28-35);
  * ``step(y_t, carry)``: one token with an explicit carry (h, c), each
    (num_layers, B, H), for the greedy decode loops, which stay fp32 as in
    the JAX package.
The Transformer and Conformer decoders raise with their ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from efficientconformer_torch.models.layers import LSTM, Embedding


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

    def forward(self, y: torch.Tensor, y_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        """y (B, U) int -> (B, U, D) in the compute dtype."""
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


def make_decoder(params: dict, vn_std: Optional[float] = None) -> RnnDecoder:
    arch = params["arch"]
    if arch != "RNN":
        raise NotImplementedError(
            f"{arch} prediction network: ROADMAP Queue 1 item 10 (Transformer and Conformer "
            "decoders, which no shipped Transducer config uses)")
    return RnnDecoder(params, vn_std)
