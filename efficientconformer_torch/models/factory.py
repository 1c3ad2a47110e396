"""Model factory: the task model and its loss from a parsed config.

Counterpart of efficientconformer_tpu/models/factory.py for the model types
the port trains so far, CTC and the Transducer. ``mixed_precision`` in
training_params maps to the JAX package's bf16 compute policy: fp32
frontend and master weights, bf16 activations in the encoder, and for the
Transducer in the prediction and joint networks on the lattice path.
``vn_std`` (variational noise) reaches the Transducer's prediction and
joint networks; a CTC model takes none, as in the JAX package. InterCTC and
the LM are not ported and raise with their ROADMAP items.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from efficientconformer_torch.models.model_ctc import ModelCTC, init_params_
from efficientconformer_torch.models.transducer import Transducer
from efficientconformer_torch.ops.ctc_loss import ctc_loss
from efficientconformer_torch.ops.rnnt_loss import rnnt_loss


def create_model(config: dict, device, generator: torch.Generator):
    """(model, loss_fn) of a CTC or Transducer config on ``device``, weights
    drawn from ``generator`` (a CPU generator). loss_fn(outputs, batch) ->
    scalar."""
    mtype = config["model_type"]
    tp = config.get("training_params", {})

    def with_policy(params: dict) -> dict:
        params = dict(params)
        if tp.get("mixed_precision") and "compute_dtype" not in params:
            params["compute_dtype"] = "bfloat16"
        return params

    enc_params = with_policy(config["encoder_params"])
    if mtype == "CTC":
        model, loss = ModelCTC(enc_params, config["tokenizer_params"]["vocab_size"]), ctc_loss_fn
    elif mtype == "Transducer":
        model = Transducer(enc_params, with_policy(config["decoder_params"]),
                           with_policy(config["joint_params"]),
                           config["decoder_params"]["vocab_size"], tp.get("vn_std"))
        loss = transducer_loss_fn
    else:
        raise NotImplementedError(f"{mtype} models: ROADMAP Queue 1 items 9 and 11")
    init_params_(model, generator)
    return model.to(device), loss


def ctc_loss_fn(outputs, batch) -> torch.Tensor:
    """Batch mean of the CTC loss of fp32 log-softmaxed logits."""
    logits, f_len = outputs
    lp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return ctc_loss(lp, batch["labels"], f_len, batch["label_len"]).mean()


def transducer_loss_fn(outputs, batch) -> torch.Tensor:
    """Batch mean of the RNN-T loss of the joint lattice (factory.py:60-64)."""
    logits, f_len = outputs
    return rnnt_loss(logits, batch["labels"], f_len, batch["label_len"]).mean()


def apply_model(model, batch, train: bool, generator=None):
    """Forward pass in training or eval mode, dispatched on the model type:
    (logits, logits_len). In training mode SpecAugment and dropout draw
    from ``generator`` and BatchNorm updates its running statistics; eval
    runs without autograd."""
    model.train(train)
    with contextlib.nullcontext() if train else torch.no_grad():
        if isinstance(model, Transducer):
            return model(batch["audio"], batch["labels"], batch["audio_len"],
                         batch["label_len"], generator)
        return model(batch["audio"], batch["audio_len"], generator)
