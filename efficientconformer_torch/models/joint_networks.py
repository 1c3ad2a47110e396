"""RNN-T joint network.

Counterpart of efficientconformer_tpu/models/joint_networks.py. Lattice mode
joins every encoder frame with every decoder state by broadcasting,
f (B, T, De) x g (B, U+1, Dd) -> (B, T, U+1, V), in the compute dtype when
one is set (bf16 under mixed precision, joint_networks.py:51-58). ``step``,
``project_encoder`` and ``row`` serve the greedy decode loops. Modes "sum"
and "concat"; activations tanh, relu, swish or none; without ``dim_model``
the frames and states enter unprojected.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from efficientconformer_torch.models.layers import Linear, swish

_ACTS = {"tanh": torch.tanh, "relu": torch.relu, "swish": swish, None: lambda x: x}


class JointNetwork(nn.Module):
    def __init__(self, dim_encoder: int, dim_decoder: int, vocab_size: int, params: dict,
                 vn_std: Optional[float] = None):
        super().__init__()
        p = params
        if p["act"] not in _ACTS or p["joint_mode"] not in ("sum", "concat"):
            raise ValueError(f"joint act {p['act']!r} / mode {p['joint_mode']!r}")
        self.mode, self.act = p["joint_mode"], _ACTS[p["act"]]
        dm = p["dim_model"]
        if dm is not None:
            self.linear_encoder = Linear(dim_encoder, dm, vn_std=vn_std)
            self.linear_decoder = Linear(dim_decoder, dm, vn_std=vn_std)
            dim_encoder = dim_decoder = dm
        else:
            self.linear_encoder = self.linear_decoder = None
        dim_joint = dim_encoder + dim_decoder if self.mode == "concat" else dim_encoder
        self.linear_joint = Linear(dim_joint, vocab_size, vn_std=vn_std)
        dtype = p.get("compute_dtype")
        self.compute_dtype = getattr(torch, dtype) if dtype else None

    def _join(self, f, g):
        if self.mode == "concat":
            shape = torch.broadcast_shapes(f.shape[:-1], g.shape[:-1])
            return torch.cat([f.expand(*shape, -1), g.expand(*shape, -1)], dim=-1)
        return f + g

    def forward(self, f, g):
        """Lattice mode: f (B, T, De), g (B, U+1, Dd) -> (B, T, U+1, V)."""
        if self.compute_dtype is not None:
            f, g = f.to(self.compute_dtype), g.to(self.compute_dtype)
        if self.linear_encoder is not None:
            f, g = self.linear_encoder(f), self.linear_decoder(g)
        return self.linear_joint(self.act(self._join(f[:, :, None], g[:, None])))

    def step(self, f, g):
        """Decode mode: f (B, De), g (B, Dd) -> (B, V)."""
        if self.linear_encoder is not None:
            f, g = self.linear_encoder(f), self.linear_decoder(g)
        return self.linear_joint(self.act(self._join(f, g)))

    def project_encoder(self, f):
        """(B, T, De) -> (B, T, Dj): the frames projected once, for ``row``."""
        return self.linear_encoder(f) if self.linear_encoder is not None else f

    def row(self, pf, g):
        """One decoder state against all frames: pf (B, T, Dj) projected
        frames, g (B, Dd) -> (B, T, V); the ops of ``step`` per frame."""
        if self.linear_decoder is not None:
            g = self.linear_decoder(g)
        return self.linear_joint(self.act(self._join(pf, g[:, None])))
