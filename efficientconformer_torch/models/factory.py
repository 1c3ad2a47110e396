"""Model factory: the task model and its loss from a parsed config.

Counterpart of efficientconformer_tpu/models/factory.py for the model types
the port trains: CTC, InterCTC, the Transducer and the LM. ``mixed_precision``
in training_params maps to the JAX package's bf16 compute policy: fp32
frontend and master weights, bf16 activations in the encoder, for the
Transducer in the prediction and joint networks on the lattice path, and
for the LM after the embedding. ``vn_std`` (variational noise) reaches the
Transducer's prediction and joint networks; a CTC model and an LM take
none, as in the JAX package. InterCTC is the CTC model with taps after the
blocks of ``encoder_params["interctc_blocks"]``; its loss mixes the main
CTC loss with the taps' (factory.py:68-92).

Batches, as the JAX package's: ASR {audio (B, T), audio_len (B,), labels
(B, U), label_len (B,)}; LM {tokens (B, U), token_len (B,), targets
(B, U+1) with -1 padding}.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from efficientconformer_torch.models.lm import LanguageModel, ce_loss
from efficientconformer_torch.models.model_ctc import ModelCTC, init_params_
from efficientconformer_torch.models.transducer import Transducer
from efficientconformer_torch.ops.ctc_loss import ctc_loss
from efficientconformer_torch.ops.rnnt_loss import rnnt_loss


def create_model(config: dict, device, generator: torch.Generator):
    """(model, loss_fn) of a CTC, InterCTC, Transducer or LM config on ``device``,
    weights drawn from ``generator`` (a CPU generator). loss_fn(outputs,
    batch) -> scalar."""
    mtype = config["model_type"]
    tp = config.get("training_params", {})

    def with_policy(params: dict) -> dict:
        params = dict(params)
        if tp.get("mixed_precision") and "compute_dtype" not in params:
            params["compute_dtype"] = "bfloat16"
        return params

    vocab = config["tokenizer_params"]["vocab_size"]
    if mtype == "CTC":
        model, loss = ModelCTC(with_policy(config["encoder_params"]), vocab), ctc_loss_fn
    elif mtype == "Transducer":
        model = Transducer(with_policy(config["encoder_params"]),
                           with_policy(config["decoder_params"]),
                           with_policy(config["joint_params"]),
                           config["decoder_params"]["vocab_size"], tp.get("vn_std"))
        loss = transducer_loss_fn
    elif mtype == "InterCTC":
        model = ModelCTC(with_policy(config["encoder_params"]), vocab,
                         tuple(config["encoder_params"].get("interctc_blocks", ())))
        loss = interctc_loss_fn(tp.get("interctc_lambda", 0.5))
    elif mtype == "LM":
        model, loss = LanguageModel(with_policy(config["lm_params"]), vocab), lm_loss_fn
    else:
        raise ValueError(f"unknown model type {mtype}")
    init_params_(model, generator)
    return model.to(device), loss


def ctc_loss_fn(outputs, batch) -> torch.Tensor:
    """Batch mean of the CTC loss of fp32 log-softmaxed logits."""
    logits, f_len = outputs
    lp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return ctc_loss(lp, batch["labels"], f_len, batch["label_len"]).mean()


# the CTC loss decides on the host which lattices are feasible, without a
# synchronisation when it is given host labels: the Trainer keeps them there
ctc_loss_fn.host_labels = True


def interctc_loss_fn(lam: float):
    """The InterCTC loss (factory.py:77-92): the batch mean of (1 - lam) *
    the main CTC loss + lam * the mean over the taps of the CTC loss of
    log p_i. Every tap is scored with the final output lengths, as the JAX
    package scores them, also a tap before a strided block, whose extra
    frames then lie past those lengths."""

    def loss_fn(outputs, batch) -> torch.Tensor:
        logits, f_len, probs = outputs
        lp = F.log_softmax(logits.to(torch.float32), dim=-1)
        args = (batch["labels"], f_len, batch["label_len"])
        main = ctc_loss(lp, *args)
        if not probs:
            return main.mean()
        inter = sum(ctc_loss(torch.log(p.to(torch.float32)), *args) for p in probs) / len(probs)
        return ((1 - lam) * main + lam * inter).mean()

    loss_fn.host_labels = True
    return loss_fn


def transducer_loss_fn(outputs, batch) -> torch.Tensor:
    """Batch mean of the RNN-T loss of the joint lattice (factory.py:60-64)."""
    logits, f_len = outputs
    return rnnt_loss(logits, batch["labels"], f_len, batch["label_len"]).mean()


def lm_loss_fn(logits, batch) -> torch.Tensor:
    """Mean cross entropy over the positions with a target (factory.py:96-104)."""
    return ce_loss(logits, batch["targets"])


def apply_model(model, batch, train: bool, generator=None):
    """Forward pass in training or eval mode, dispatched on the model type:
    (logits, logits_len) of an ASR model (and the taps' probabilities of an
    InterCTC model), the logits of an LM. In training
    mode SpecAugment and dropout draw from ``generator`` and BatchNorm
    updates its running statistics; eval runs without autograd."""
    model.train(train)
    with contextlib.nullcontext() if train else torch.no_grad():
        if isinstance(model, LanguageModel):
            return model(batch["tokens"], batch["token_len"], generator)
        if isinstance(model, Transducer):
            return model(batch["audio"], batch["labels"], batch["audio_len"],
                         batch["label_len"], generator)
        return model(batch["audio"], batch["audio_len"], generator)
