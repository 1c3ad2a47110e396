"""Efficient Conformer in PyTorch for NVIDIA Hopper (H100).

The port of efficientconformer_tpu/ (JAX/Flax/Pallas, the reference, which
stays in the repository). Module paths mirror the JAX package's. Plain tensor
code is PyTorch; each Pallas kernel of the JAX package becomes a kernel
written by hand for Hopper, under csrc/, built by ops/_kernels.py at first
use. Nothing here imports JAX or the JAX package.

Ported so far: batched greedy CTC inference of the Efficient Conformer CTC
models (models/model_ctc.py:build_model, greedy_decode).
"""
