"""Model factory: the task model and its loss from a parsed config.

Counterpart of efficientconformer_tpu/models/factory.py for the one model
type the port trains so far, CTC. ``mixed_precision`` in training_params
maps to the JAX package's bf16 compute policy: fp32 frontend and master
weights, bf16 activations. Variational noise (``vn_std``), InterCTC, the
Transducer and the LM are not ported and raise with their ROADMAP items.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from efficientconformer_torch.models.model_ctc import ModelCTC, init_params_
from efficientconformer_torch.ops.ctc_loss import ctc_loss


def create_model(config: dict, device, generator: torch.Generator):
    """(model, loss_fn) of a CTC config on ``device``, weights drawn from
    ``generator`` (a CPU generator). loss_fn(outputs, batch) -> scalar."""
    mtype = config["model_type"]
    if mtype != "CTC":
        raise NotImplementedError(f"{mtype} models: ROADMAP Queue 1 items 9-11")
    tp = config.get("training_params", {})
    if tp.get("vn_std") is not None:
        raise NotImplementedError("variational noise (vn_std): ROADMAP Queue 1 item 8")
    enc_params = dict(config["encoder_params"])
    if tp.get("mixed_precision") and "compute_dtype" not in enc_params:
        enc_params["compute_dtype"] = "bfloat16"
    model = ModelCTC(enc_params, config["tokenizer_params"]["vocab_size"])
    init_params_(model, generator)
    return model.to(device), loss_fn


def loss_fn(outputs, batch) -> torch.Tensor:
    """Batch mean of the CTC loss of fp32 log-softmaxed logits."""
    logits, f_len = outputs
    lp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return ctc_loss(lp, batch["labels"], f_len, batch["label_len"]).mean()


def apply_model(model: ModelCTC, batch, train: bool, generator=None):
    """Forward pass in training or eval mode: (logits, logits_len). In
    training mode SpecAugment and dropout draw from ``generator`` and
    BatchNorm updates its running statistics; eval runs without autograd."""
    model.train(train)
    if train:
        return model(batch["audio"], batch["audio_len"], generator)
    with torch.no_grad():
        return model(batch["audio"], batch["audio_len"])
