"""Selection in the JAX package's tie order.

The beams' results depend on how ties are broken, and dead slots all hold
the same -1e30, so ties are the rule there. ``jax.lax.top_k`` returns the
lowest index first among equal values, ``jnp.argsort`` is stable and
``jnp.argmax`` takes the first maximum. ``torch.topk`` promises no order
among ties (on CUDA least of all), so the beams select through ``top_k``
here; ``torch.argmax`` already returns the first maximum.
"""

from __future__ import annotations

import torch


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis, the
    lowest index first among equal values (``jax.lax.top_k``)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def argsort(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Ascending, equal values in their original order (``jnp.argsort``)."""
    return torch.sort(x, dim=dim, stable=True).indices
