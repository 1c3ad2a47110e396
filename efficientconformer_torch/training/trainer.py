"""Trainer: the training step of the CTC and Transducer models.

Counterpart of the train step of efficientconformer_tpu/training/trainer.py
(``Trainer.train_step_fn``, ``fit``): one optimizer update per batch of A
stacked microbatches (``accumulated_steps``). Each microbatch runs forward
and backward in turn, so BatchNorm's running statistics are updated
microbatch by microbatch, as the JAX package's scan does; the gradients are
averaged over the A microbatches and the reported loss is their mean loss.
``freeze_encoder`` (while step <= ``encoder_frozen_steps``) zeroes the
encoder's gradients and its updates: the optimizer still advances its
moments (with the weight-decay term, as optax does), and the encoder's
weights are put back after the step. From ``vn_start_step`` on, variational
noise is drawn once per step, before the first microbatch, and every
microbatch of the step sees that draw (trainer.py:130-134, :263-266).

The device is explicit and defaults to the card: without a GPU the default
raises, and the trainer never moves to the CPU on its own. Dropout,
SpecAugment and the variational noise draw from an explicit
``torch.Generator`` on that device. Checkpoints, SWA, data loaders and the
CLI are not ported (ROADMAP Queue 1 items 8 and 13).
"""

from __future__ import annotations

import itertools
from typing import Iterable, Optional, Union

import numpy as np
import torch

from efficientconformer_torch.config import default_device, encoder_output_frames, load_config
from efficientconformer_torch.models import factory
from efficientconformer_torch.models.layers import (
    clear_variational_noise_,
    draw_variational_noise_,
)
from efficientconformer_torch.training import optimizers


class Trainer:
    """Builds the model, optimizer and schedule of a config (a path, or the
    parsed JSON dict) on ``device``, with weights drawn from ``seed``."""

    def __init__(self, config: Union[str, dict], device=None, seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        self.config = load_config(config) if isinstance(config, str) else config
        tp = self.config["training_params"]
        self.device = torch.device(device) if device is not None else default_device()
        self.model, self.loss_fn = factory.create_model(
            self.config, self.device, torch.Generator().manual_seed(seed))
        self.optimizer, self.schedule = optimizers.from_training_params(
            self.model.parameters(), tp)
        self.generator = generator if generator is not None else torch.Generator(
            device=self.device).manual_seed(seed + 1)
        self.encoder_frozen_steps = tp.get("encoder_frozen_steps")
        self.vn_start_step = tp.get("vn_start_step")
        self.step = 0

    def train_step(self, batch: dict, freeze_encoder: Optional[bool] = None):
        """One optimizer update. ``batch``: audio (A, B, T), audio_len (A, B),
        labels (A, B, U), label_len (A, B) as tensors or numpy arrays; audio
        and labels may already lie on the device. Returns (mean loss, global
        gradient norm) as 0-d tensors on the device.

        The lengths are read on the host once, at the start of the step: the
        encoder's output lengths follow from them by the config's arithmetic,
        so the loss gets host lengths and copies none back from the
        device."""
        if freeze_encoder is None:
            freeze_encoder = (self.encoder_frozen_steps is not None
                              and self.step <= self.encoder_frozen_steps)
        model, opt = self.model, self.optimizer
        batch = {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
                 for k, v in batch.items()}
        enc_params = self.config["encoder_params"]
        audio_len = batch["audio_len"].cpu()
        label_len = batch["label_len"].cpu()
        logit_len = torch.tensor([[encoder_output_frames(enc_params, n) for n in row]
                                  for row in audio_len.tolist()])
        audio_len_dev = audio_len.to(self.device)
        accum = batch["audio"].shape[0]
        model.train()
        opt.zero_grad(set_to_none=True)
        if self.vn_start_step is not None and self.step >= self.vn_start_step:
            draw_variational_noise_(model, self.generator)
        total = torch.zeros((), device=self.device)
        try:
            for a in range(accum):
                mb = {"audio": batch["audio"][a].to(self.device, non_blocking=True),
                      "audio_len": audio_len_dev[a],
                      "labels": batch["labels"][a].to(self.device, non_blocking=True),
                      "label_len": label_len[a]}
                logits, _ = factory.apply_model(model, mb, True, self.generator)
                loss = self.loss_fn((logits, logit_len[a]), mb)
                (loss / accum).backward()
                total += loss.detach()
        finally:
            clear_variational_noise_(model)

        params = list(model.parameters())
        for p in params:
            # a parameter outside the loss (the pos layer's bias, which cancels
            # in the softmax) gets a zero gradient, so that weight decay moves
            # it as optax moves it
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        encoder = list(model.encoder.parameters()) if freeze_encoder else []
        for p in encoder:
            p.grad.zero_()
        grad_norm = torch.nn.utils.get_total_norm([p.grad for p in params])
        kept = [p.detach().clone() for p in encoder]
        optimizers.set_lr(opt, self.schedule(self.step))
        opt.step()
        with torch.no_grad():
            for p, old in zip(encoder, kept):
                p.copy_(old)
        self.step += 1
        return total / accum, grad_norm

    def fit(self, batches: Iterable[dict], steps: int) -> list[float]:
        """``train_step`` over up to ``steps`` batches; the losses."""
        losses = [self.train_step(batch)[0] for batch in itertools.islice(batches, steps)]
        return [float(loss) for loss in losses]
