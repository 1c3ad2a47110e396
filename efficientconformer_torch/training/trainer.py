"""Trainer: the training step of the CTC, InterCTC, Transducer and LM
models, and the eval loss.

Counterpart of the train and eval steps of
efficientconformer_tpu/training/trainer.py (``Trainer.train_step_fn``,
``eval_loss_fn``, ``fit``): one optimizer update per batch of A stacked
microbatches (``accumulated_steps``). Each microbatch runs forward and
backward in turn, so BatchNorm's running statistics are updated microbatch
by microbatch, as the JAX package's scan does; the gradients are averaged
over the A microbatches and the reported loss is their mean loss. An LM has
no encoder, so it has nothing to freeze.
``freeze_encoder`` (while step <= ``encoder_frozen_steps``) zeroes the
encoder's gradients and its updates: the optimizer still advances its
moments (with the weight-decay term, as optax does), and the encoder's
weights are put back after the step. From ``vn_start_step`` on, variational
noise is drawn once per step, before the first microbatch, and every
microbatch of the step sees that draw (trainer.py:130-134, :263-266).

The device is explicit and defaults to the card: without a GPU the default
raises, and the trainer never moves to the CPU on its own. Dropout,
SpecAugment and the variational noise draw from an explicit
``torch.Generator`` on that device.

``fit_epochs`` is the JAX package's epoch loop (``Trainer.fit``): epochs of
loader batches, validation and a checkpoint every so many epochs;
``save`` and ``load`` go through training/checkpoint.py, and a loaded
checkpoint continues the step counter, which decides the variational noise
and the encoder freezing.

Data parallelism (parallel/mesh.py; the JAX package's data mesh): inside a
process group of more than one rank (or with ``ddp=True``) the model is
wrapped in ``DistributedDataParallel`` and each rank steps on its shard of
the global batch; BatchNorm takes the global batch's statistics
(models/layers.py). DDP averages the gradients over the ranks in the last
microbatch's backward (``no_sync`` before it); each rank's loss is weighted
by its share of the global mean, so the gradients, the reported loss and
the gradient norm are those of the global batch: for the ASR losses, means
over equal shards, the weight is 1; for the LM's mean over the positions
with a target, the rank's count over the global count. Parameters outside
the loss (the pos layer's bias, which cancels in the softmax) get no
gradient on any rank: DDP finds them every forward
(``find_unused_parameters``) and leaves their gradients unset, and the
trainer fills them with zeros after the reduction, as without DDP. The
variational noise is drawn from a generator seeded from ``seed`` alone, the
same on every rank (trainer.py:130-133); dropout and SpecAugment from one
seeded by (seed, rank). At one rank every stream is the one without DDP.
Checkpoints are written by rank 0, from the unwrapped model, and the
epoch's lines printed by it.

Tensor parallelism (``training_params["model_parallel"]`` n, as the JAX
package's trainer.py:74-82 reads it; parallel/tensor.py): the world is split
into data groups and model groups of n ranks (``mesh.make_grid``), the model
is built whole from the seed on every rank and cut to the rank's shards
(``tensor.shard_model_``) before the optimizer, whose state follows the
shards, is made. Everything above that reads "rank" and "the ranks" then
reads the data axis: DDP reduces over the data group, the loss's mean and
the LM's shares over it, and the dropout and SpecAugment stream is seeded by
the data index, so the replicated activations stay equal across a model
group (the ranks of one group draw the same masks; a dropout inside a
parallel region draws the whole width's mask and keeps its slice). The
replicated parameters' gradients are averaged over the model group (one
all-reduce: on the card, atomics may sum them in another order on each
rank), so the replicas stay bit for bit equal. The gradient norm sums a
sharded parameter's squares over the model group and counts a replicated
one once. Checkpoints hold the full layout
(``tensor.gather_state_dict``), written by rank 0 and cut to the shards on
loading, so they load at any model size.

Sequence parallelism (``training_params["seq_parallel"]`` S, as the JAX
package's trainer.py:74-88 reads it; parallel/sequence.py): the grid gains
a seq axis between data and model (``mesh.make_grid(M, S)``), and the
encoder splits its activations along time over the seq group
(``sequence.shard_encoder_``). The ranks of one seq group take the same rows
and draw from the same dropout and SpecAugment stream (the stream is seeded
by the data index), and every one of them computes the whole loss from the
gathered frames. The parameters stay whole; DDP averages their gradients
over the data x seq group (``mesh.replica_group``), whose seq ranks' parts
sum to a data rank's gradient (parallel/sequence.py says how), so the step
is the one-process step. The loss is reported once (averaged over the data
group alone), and the LM's shares count data ranks only. A batch length at
which no point of the encoder splits is warned about once
(``mesh.sp_coverage_warn``), and runs replicated.
"""

from __future__ import annotations

import contextlib
import inspect
import itertools
import os
import time
from typing import Callable, Iterable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from efficientconformer_torch.config import default_device, encoder_output_frames, load_config
from efficientconformer_torch.models import factory
from efficientconformer_torch.models.layers import (
    clear_variational_noise_,
    draw_variational_noise_,
)
from efficientconformer_torch.parallel import mesh, sequence
from efficientconformer_torch.parallel import tensor
from efficientconformer_torch.training import checkpoint, optimizers


class Trainer:
    """Builds the model, optimizer and schedule of a config (a path, or the
    parsed JSON dict) on ``device`` (by default the rank's device inside a
    process group, else the card), with weights drawn from ``seed``.
    ``ddp`` wraps the model in DistributedDataParallel: by default when a
    process group of more than one data (or data x seq) rank is set up. With
    ``training_params["model_parallel"]`` n > 1 the model is sharded over
    model groups of n ranks of the process group, and with
    ``training_params["seq_parallel"]`` S > 1 its encoder's activations
    over seq groups of S ranks."""

    def __init__(self, config: Union[str, dict], device=None, seed: int = 0,
                 generator: Optional[torch.Generator] = None, ddp: Optional[bool] = None):
        self.config = load_config(config) if isinstance(config, str) else config
        tp = self.config["training_params"]
        self.device = torch.device(device) if device is not None else (
            mesh.device() or default_device())
        model_parallel = int(tp.get("model_parallel") or 1)
        seq_parallel = int(tp.get("seq_parallel") or 1)
        if model_parallel * seq_parallel > 1:
            if not dist.is_initialized():
                raise RuntimeError(f"model_parallel={model_parallel} x seq_parallel="
                                   f"{seq_parallel} needs a process group of its ranks "
                                   "(parallel/mesh.py)")
            mesh.make_grid(model_parallel, seq_parallel)
        self.model, self.loss_fn = factory.create_model(
            self.config, self.device, torch.Generator().manual_seed(seed))
        if model_parallel > 1:
            tensor.shard_model_(self.model)
        self.seq_parallel = seq_parallel
        if seq_parallel > 1 and hasattr(self.model, "encoder"):
            sequence.shard_encoder_(self.model.encoder, sequence.region())
        self._seen_lengths: set = set()
        self.optimizer, self.schedule = optimizers.from_training_params(
            self.model.parameters(), tp)
        rank, world = mesh.data_rank(), mesh.data_size()
        # dropout and SpecAugment: a stream of each data rank's own; the VN
        # draw: one stream, the same on every rank (at one data rank, the one
        # stream)
        own = seed + 1 if world == 1 else int(np.random.SeedSequence([seed, rank])
                                              .generate_state(1)[0])
        self.generator = generator if generator is not None else torch.Generator(
            device=self.device).manual_seed(own)
        self.vn_generator = self.generator if world == 1 else torch.Generator(
            device=self.device).manual_seed(seed + 1)
        self.ddp = None
        replicas = mesh.grid().replica_size
        if ddp if ddp is not None else replicas > 1:
            if not dist.is_initialized():
                raise RuntimeError("ddp=True needs a process group (parallel/mesh.py)")
            if model_parallel > 1 and replicas == 1:
                raise ValueError("ddp=True over one data rank under tensor parallelism")
            mesh.check_same_parameters(self.model)
            # every rank updates the running statistics from the same global
            # statistics, so the buffers need no broadcast before a forward
            no_buffer_sync = ({"forward_sync_buffers": False} if "forward_sync_buffers" in
                              inspect.signature(DistributedDataParallel).parameters
                              else {"broadcast_buffers": False})
            self.ddp = DistributedDataParallel(self.model, process_group=mesh.replica_group(),
                                               find_unused_parameters=True, **no_buffer_sync)
        self.encoder_frozen_steps = tp.get("encoder_frozen_steps")
        self.vn_start_step = tp.get("vn_start_step")
        self.step = 0

    def train_step(self, batch: dict, freeze_encoder: Optional[bool] = None):
        """One optimizer update. ``batch``, as tensors or numpy arrays, for
        an ASR model: audio (A, B, T), audio_len (A, B), labels (A, B, U),
        label_len (A, B); for an LM: tokens (A, B, U), token_len (A, B),
        targets (A, B, U+1) with -1 padding. Audio, labels, tokens and
        targets may already lie on the device. Returns (mean loss, global
        gradient norm) as 0-d tensors on the device."""
        if freeze_encoder is None:
            freeze_encoder = (self.encoder_frozen_steps is not None
                              and self.step <= self.encoder_frozen_steps)
        model, opt = self.model, self.optimizer
        if freeze_encoder and not hasattr(model, "encoder"):
            raise ValueError("freeze_encoder: the model has no encoder")
        batch = {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
                 for k, v in batch.items()}
        if self.seq_parallel > 1 and "audio" in batch:
            t_audio = int(batch["audio"].shape[-1])
            if t_audio not in self._seen_lengths:
                self._seen_lengths.add(t_audio)
                mesh.sp_coverage_warn(self.config["encoder_params"], self.seq_parallel, t_audio)
        model.train()
        opt.zero_grad(set_to_none=True)
        if self.vn_start_step is not None and self.step >= self.vn_start_step:
            draw_variational_noise_(model, self.vn_generator)
        total = torch.zeros((), device=self.device)
        microbatches = self._microbatches(batch)
        net = self.ddp or model
        try:
            for i, (mb, out_len) in enumerate(microbatches):
                # DDP reduces the accumulated gradients in the last backward
                last = self.ddp is None or i == len(microbatches) - 1
                with contextlib.nullcontext() if last else self.ddp.no_sync():
                    outputs = factory.apply_model(net, mb, True, self.generator)
                    if out_len is not None:
                        outputs = (outputs[0], out_len, *outputs[2:])
                    loss = self.loss_fn(outputs, mb)
                    share = self._share(mb)
                    if share is not None:
                        loss = loss * share
                    (loss / len(microbatches)).backward()
                total += loss.detach()
        finally:
            clear_variational_noise_(model)
        if mesh.data_size() > 1:
            # the global batch's mean loss, the same on every rank
            dist.all_reduce(total, group=mesh.data_group())
            total /= mesh.data_size()

        params = list(model.parameters())
        for p in params:
            # a parameter outside the loss (the pos layer's bias, which cancels
            # in the softmax) gets a zero gradient, so that weight decay moves
            # it as optax moves it
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        tensor.sync_replicated_grads(model)
        encoder = list(model.encoder.parameters()) if freeze_encoder else []
        for p in encoder:
            p.grad.zero_()
        grad_norm = tensor.grad_norm(model, [p.grad for p in params])
        kept = [p.detach().clone() for p in encoder]
        optimizers.set_lr(opt, self.schedule(self.step))
        opt.step()
        with torch.no_grad():
            for p, old in zip(encoder, kept):
                p.copy_(old)
        self.step += 1
        return total / len(microbatches), grad_norm

    def _share(self, mb: dict):
        """The weight of this rank's loss: W times its share of the global
        batch's mean over the W data ranks (DDP averages). None (1) without a
        group, and for a mean over the utterances of equal shards; for a mean
        over counted terms (the LM's positions with a target,
        ``loss_fn.count``) the rank's count times W over the global count."""
        count = getattr(self.loss_fn, "count", None)
        world = mesh.data_size()
        if world == 1 or count is None:
            return None
        mine = count(mb).to(torch.float32)
        every = mine.clone()
        dist.all_reduce(every, group=mesh.data_group())
        return mine * world / every.clamp(min=1.0)

    def _microbatches(self, batch: dict) -> list:
        """(microbatch on the device, the output lengths the loss takes) for
        each of the A microbatches. An LM's loss takes none. An ASR model's
        lengths are read on the host once: the encoder's output lengths
        follow from them by the config's arithmetic, so the loss gets host
        lengths and copies none back from the device. The labels stay on the
        host where the loss asks for them there (``loss_fn.host_labels``):
        they are copied back, if given on the card, before any of the step's
        work is queued."""
        dev = self.device
        if "tokens" in batch:
            return [({k: batch[k][a].to(dev, non_blocking=True)
                      for k in ("tokens", "token_len", "targets")}, None)
                    for a in range(batch["tokens"].shape[0])]
        enc_params = self.config["encoder_params"]
        audio_len = batch["audio_len"].cpu()
        label_len = batch["label_len"].cpu()
        host_labels = getattr(self.loss_fn, "host_labels", False)
        labels = batch["labels"].cpu() if host_labels else batch["labels"]
        logit_len = torch.tensor([[encoder_output_frames(enc_params, n) for n in row]
                                  for row in audio_len.tolist()])
        audio_len_dev = audio_len.to(dev)
        return [({"audio": batch["audio"][a].to(dev, non_blocking=True),
                  "audio_len": audio_len_dev[a],
                  "labels": labels[a] if host_labels else labels[a].to(dev, non_blocking=True),
                  "label_len": label_len[a]}, logit_len[a])
                for a in range(batch["audio"].shape[0])]

    def eval_loss(self, batch: dict) -> torch.Tensor:
        """The eval-mode loss of one batch without the accumulation axis
        (``Trainer.eval_loss_fn``), as a 0-d tensor on the device: for an LM
        batch, tokens (B, U), token_len (B,), targets (B, U+1), the mean
        cross entropy, whose exponential is the perplexity."""
        mb = {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
              for k, v in batch.items()}
        mb = {k: v.to(self.device, non_blocking=True) for k, v in mb.items()}
        with torch.no_grad():
            return self.loss_fn(factory.apply_model(self.model, mb, False), mb)

    def fit(self, batches: Iterable[dict], steps: int) -> list[float]:
        """``train_step`` over up to ``steps`` batches; the losses."""
        losses = [self.train_step(batch)[0] for batch in itertools.islice(batches, steps)]
        return [float(loss) for loss in losses]

    def fit_epochs(self, epoch_batches: Callable[[int], Iterable[dict]], *, epochs: int,
                   steps_per_epoch: Optional[int] = None, initial_epoch: int = 0,
                   callback_path: Optional[str] = None,
                   val_fn: Optional[Callable[["Trainer"], dict]] = None, saving_period: int = 1,
                   val_period: int = 1, log_writer=None) -> list[dict]:
        """The epoch loop (the JAX package's ``Trainer.fit``, trainer.py:214-358;
        reference model.py:173-344): epochs ``initial_epoch`` .. ``epochs`` - 1,
        each over ``epoch_batches(epoch)`` (a loader's ``epoch``), at most
        ``steps_per_epoch`` steps. A batch's ``n_valid`` is dropped before the
        step. ``val_fn(trainer) -> dict`` runs every ``val_period`` epochs;
        ``checkpoints_{epoch}.ckpt`` is saved under ``callback_path`` every
        ``saving_period`` epochs. The loss is read back to the host where the
        JAX package reads it (the first step of an epoch, then every tenth,
        for the progress bar and ``log_writer``), never every step: a
        readback drains the device's queue. One record per epoch: its
        number, mean loss, steps, seconds and validation metrics."""
        history = []
        main = mesh.is_main()      # under a process group, rank 0 prints
        try:
            for epoch in range(initial_epoch, epochs):
                t0 = time.perf_counter()
                losses = []
                batches = epoch_batches(epoch)
                it, bar = batches, None
                try:
                    from tqdm import tqdm

                    if main:
                        print(f"Epoch {epoch + 1}/{epochs}")
                        it = bar = tqdm(batches, total=steps_per_epoch)
                except ImportError:
                    pass
                try:
                    for i, batch in enumerate(it):
                        batch = {k: v for k, v in batch.items() if k != "n_valid"}
                        loss, _ = self.train_step(batch)
                        losses.append(loss)
                        if bar is not None and ((i + 1) % 10 == 0 or i == 0):
                            bar.set_description(
                                "model step: {} - mean loss {:.4f} - batch loss: {:.4f} - "
                                "learning rate: {:.6f}".format(
                                    self.step, float(torch.stack(losses).mean()), float(loss),
                                    self.schedule(self.step - 1)))
                        if log_writer is not None and (i + 1) % 10 == 0:
                            log_writer.add_scalar("Training/Loss", float(loss), self.step)
                            log_writer.add_scalar("Training/LearningRate",
                                                  self.schedule(self.step - 1), self.step)
                        if steps_per_epoch and i + 1 >= steps_per_epoch:
                            break
                finally:
                    if bar is not None:
                        bar.close()
                    if hasattr(batches, "close"):
                        batches.close()        # stops a loader's prefetch thread
                mean_loss = float(torch.stack(losses).mean()) if losses else float("nan")
                seconds = time.perf_counter() - t0
                record = {"epoch": epoch + 1, "loss": mean_loss, "steps": len(losses),
                          "seconds": seconds}
                per_step = f", {seconds * 1e3 / len(losses):.1f} ms/step" if losses else ""
                if main:
                    print(f"epoch {epoch + 1}/{epochs} loss {mean_loss:.4f} "
                          f"({seconds:.1f}s, {len(losses)} steps{per_step})")
                if log_writer is not None:
                    log_writer.add_scalar("Training/MeanLoss", mean_loss, epoch + 1)
                if val_fn is not None and (epoch + 1) % val_period == 0:
                    metrics = val_fn(self)
                    # "_text" carries an example prediction (reference model.py:326-328)
                    text = metrics.pop("_text", None)
                    record["val"] = metrics
                    if main:
                        print("  val:", {k: round(float(v), 4) for k, v in metrics.items()})
                    if log_writer is not None:
                        for k, v in metrics.items():
                            log_writer.add_scalar(f"Validation/{k}", float(v), epoch + 1)
                        if text:
                            log_writer.add_text("Validation/Predictions", text, epoch + 1)
                if callback_path and (epoch + 1) % saving_period == 0:
                    self.save(os.path.join(callback_path, f"checkpoints_{epoch + 1}.ckpt"))
                history.append(record)
        except Exception as e:
            # the exception's text to TensorBoard before re-raising
            # (reference model.py:336-344)
            if log_writer is not None:
                log_writer.add_text("Exceptions", str(e))
            raise
        return history

    def save(self, path: str, save_optimizer: bool = True) -> None:
        """Checkpoint the model, the optimizer (unless ``save_optimizer`` is
        False, as for an SWA average) and the step at ``path``: under a
        process group rank 0 writes, from the unwrapped model (so the file
        loads at any world size), in the full layout under tensor
        parallelism (the model group gathers it), and every rank waits until
        it has."""
        model_state = tensor.gather_state_dict(self.model)
        opt_state = (tensor.gather_optimizer_state(self.optimizer, self.model)
                     if save_optimizer else None)
        if mesh.is_main():
            checkpoint.write(path, model_state, opt_state, self.step)
        mesh.barrier()

    def load(self, path: str) -> None:
        """Load a checkpoint into the model, the optimizer (kept as it is
        when the file has none) and the step counter; under tensor
        parallelism the rank's shards of the file's full layout."""
        self.step = checkpoint.load(path, self.model, self.optimizer)
