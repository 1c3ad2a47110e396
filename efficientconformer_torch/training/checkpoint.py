"""Checkpoints: save, load, the encoder alone, and SWA averages.

Counterpart of efficientconformer_tpu/training/checkpoint.py (``save``,
``load``, ``load_encoder``, ``swa_average``, ``swa_exp_average``) in the
port's own format: ``torch.save`` of

    {"model": state_dict (parameters and the BatchNorm buffers),
     "optimizer": the optimizer's state_dict, or None,
     "step": optimizer updates taken}

written atomically (a temporary file, then ``os.replace``), so a crash in a
save never corrupts the checkpoint already at the path. A checkpoint saved
without its optimizer (an SWA average) loads with the template's optimizer
state kept. The JAX package's msgpack and orbax files are not read here;
a JAX state reaches the port through utils/weights.from_jax and
load_adam_state. A file holds the full layout; a model sharded by tensor
parallelism (parallel/tensor.py) loads its shards of it.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

import torch

from efficientconformer_torch.parallel import tensor


def save(path: str, model: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer],
         step: int) -> None:
    """Write ``model``'s state, ``optimizer``'s (None: without it) and the
    step to ``path``."""
    write(path, model.state_dict(), optimizer.state_dict() if optimizer is not None else None,
          step)


def write(path: str, model_state: dict, optimizer_state: Optional[dict], step: int) -> None:
    """Write a model's and an optimizer's state dicts (None: no optimizer)
    and the step to ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"model": model_state, "optimizer": optimizer_state, "step": int(step)}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def read(path: str, device="cpu") -> dict:
    """The checkpoint at ``path`` as saved, its tensors on ``device``."""
    return torch.load(path, map_location=device, weights_only=True)


def load(path: str, model: torch.nn.Module,
         optimizer: Optional[torch.optim.Optimizer] = None) -> int:
    """Load the checkpoint at ``path`` into ``model`` (every entry) and, if
    the file holds optimizer state, into ``optimizer``; the step. The file
    is read to the host: the loads copy each tensor to its parameter's
    device, but for Adam's per-parameter step count, which must stay on the
    host (on the card every update would read each one back)."""
    ckpt = read(path)
    model.load_state_dict(tensor.localize_state_dict(model, ckpt["model"]), strict=True)
    if optimizer is not None and ckpt["optimizer"] is not None:
        optimizer.load_state_dict(
            tensor.localize_optimizer_state(ckpt["optimizer"], optimizer, model))
    return ckpt["step"]


def load_encoder(path: str, model: torch.nn.Module) -> None:
    """Load only the ``encoder.`` entries (parameters and BatchNorm
    buffers) of the checkpoint at ``path`` into ``model``, the rest left as
    it is: a CTC checkpoint's encoder into a Transducer."""
    ckpt = read(path)
    encoder = tensor.localize_state_dict(
        model, {k: v for k, v in ckpt["model"].items() if k.startswith("encoder.")})
    state = model.state_dict()
    missing = [k for k in state if k.startswith("encoder.") and k not in encoder]
    unexpected = [k for k in encoder if k not in state]
    if missing or unexpected:
        raise KeyError(f"encoder entries missing {missing[:5]}, unexpected {unexpected[:5]}")
    state.update(encoder)
    model.load_state_dict(state, strict=True)


def swa_average(states: list, params: Iterable[str]) -> dict:
    """Equal-weight average of the entries named in ``params`` over the
    checkpoints ``states`` (as ``read`` gives them); the other entries (the
    BatchNorm buffers) and the step from the last state, no optimizer
    (reference model.py:498-531, swa_type 'equal')."""
    n = len(states)
    model = dict(states[-1]["model"])
    for k in params:
        model[k] = sum(s["model"][k] for s in states) / n
    return {"model": model, "optimizer": None, "step": states[-1]["step"]}


def swa_exp_average(states: list, params: Iterable[str], decay: float = 0.9) -> dict:
    """Exponential moving average of the entries named in ``params``, in
    the order of ``states``: avg <- (1 - decay) * avg + decay * new
    (reference model.py:501); the rest as ``swa_average``."""
    model = dict(states[-1]["model"])
    for k in params:
        avg = states[0]["model"][k]
        for s in states[1:]:
            avg = (1 - decay) * avg + decay * s["model"][k]
        model[k] = avg
    return {"model": model, "optimizer": None, "step": states[-1]["step"]}
