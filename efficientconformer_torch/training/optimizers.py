"""Optimizers from reference-schema training_params.

Counterpart of efficientconformer_tpu/training/optimizers.py. Adam is
``torch.optim.Adam``: L2 weight decay folded into the gradient before the
moments (not AdamW), eps added outside the square root, which is the optax
chain add_decayed_weights -> scale_by_adam(eps_root=0) of the JAX package.
SGD is ``torch.optim.SGD`` with momentum, optax's trace. The learning rate
of update i is the schedule's value at count i, set before each step
(``set_lr``).
"""

from __future__ import annotations

import torch

from efficientconformer_torch.training import schedules


def from_training_params(params, p: dict):
    """(optimizer over ``params``, schedule)."""
    schedule = schedules.from_training_params(p)
    wd = p.get("weight_decay", 0.0)
    if p["optimizer"] == "Adam":
        opt = torch.optim.Adam(params, lr=schedule(0), betas=(p["beta1"], p["beta2"]),
                               eps=p["eps"], weight_decay=wd)
    elif p["optimizer"] == "SGD":
        opt = torch.optim.SGD(params, lr=schedule(0), momentum=p.get("momentum", 0.0),
                              weight_decay=wd)
    else:
        raise ValueError(f"unknown optimizer {p['optimizer']}")
    return opt, schedule


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
