"""Efficient Conformer in PyTorch for NVIDIA Hopper (H100).

The port of efficientconformer_tpu/ (JAX/Flax/Pallas, the reference, which
stays in the repository). Module paths mirror the JAX package's. Plain tensor
code is PyTorch; each Pallas kernel of the JAX package becomes a kernel
written by hand for Hopper, under csrc/, built by ops/_kernels.py at first
use. Nothing here imports JAX or the JAX package.

Ported so far, for the Efficient Conformer CTC models: batched greedy CTC
inference (models/model_ctc.py:build_model, greedy_decode) and the training
step (training/trainer.py:Trainer: SpecAugment, dropout, batch-statistics
BatchNorm, CTC loss, gradient accumulation, torch-semantics Adam under the
config's schedule, bf16 mixed precision). For the Transducers with an RNN
prediction network: batched greedy decoding (models/transducer.py:
build_model, greedy_decode) and the same training step with the RNN-T loss
and variational noise. For the language models: scoring and training. And
the CLI (``python -m efficientconformer_torch.main``, runtime.py) with the
data path (data/), checkpoints and SWA (training/checkpoint.py) and the
epoch loop (``Trainer.fit_epochs``); InterCTC; beam search on the device and
on the host (decoding/) with n-gram and LM fusion; streaming and serving;
``--profiler`` (utils/profiling.py); the import of the original repo's
checkpoints (``python -m efficientconformer_torch.import_checkpoint``); and
data parallelism over GPUs (parallel/mesh.py, DDP in the Trainer, the CLI's
``-d``; dryrun.py).
"""
