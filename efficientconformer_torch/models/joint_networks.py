"""RNN-T joint network.

Counterpart of efficientconformer_tpu/models/joint_networks.py. Lattice mode
joins every encoder frame with every decoder state by broadcasting,
f (B, T, De) x g (B, U+1, Dd) -> (B, T, U+1, V), in the compute dtype when
one is set (bf16 under mixed precision, joint_networks.py:51-58). ``step``,
``project_encoder`` and ``row`` serve the greedy decode loops. Modes "sum"
and "concat"; activations tanh, relu, swish or none; without ``dim_model``
the frames and states enter unprojected.

Under tensor parallelism (``tp`` set by parallel/tensor.shard_model_) every
projection is column-parallel: the frame and state projections gathered
whole before the broadcast join (never the (B, T, U+1, Dj) activations),
the join's inputs entering the model group, and the vocabulary projection
on the rank's slice of the vocabulary, its logits gathered whole for the
RNN-T loss.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from efficientconformer_torch.models.layers import Linear, swish
from efficientconformer_torch.parallel import tensor as tp_ops

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
        self.tp = None

    def _enter(self, f, g):
        """f and g entering the model group under tensor parallelism."""
        if self.tp is None:
            return f, g
        return tp_ops.copy_to_region(f, self.tp), tp_ops.copy_to_region(g, self.tp)

    def _logits(self, z):
        """The vocabulary projection, gathered whole under tensor parallelism."""
        out = self.linear_joint(z)
        return out if self.tp is None else tp_ops.gather_features(out, self.tp)

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
        f, g = self._enter(f, g)
        return self._logits(self.act(self._join(f[:, :, None], g[:, None])))

    def step(self, f, g):
        """Decode mode: f (B, De), g (B, Dd) -> (B, V)."""
        if self.linear_encoder is not None:
            f, g = self.linear_encoder(f), self.linear_decoder(g)
        return self._logits(self.act(self._join(*self._enter(f, g))))

    def project_encoder(self, f):
        """(B, T, De) -> (B, T, Dj): the frames projected once, for ``row``."""
        return self.linear_encoder(f) if self.linear_encoder is not None else f

    def row(self, pf, g):
        """One decoder state against all frames: pf (B, T, Dj) projected
        frames, g (B, Dd) -> (B, T, V); the ops of ``step`` per frame."""
        if self.linear_decoder is not None:
            g = self.linear_decoder(g)
        pf, g = self._enter(pf, g)
        return self._logits(self.act(self._join(pf, g[:, None])))
