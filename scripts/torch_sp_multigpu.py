#!/usr/bin/env python3
"""Sequence parallelism across GPUs: the port's seq groups over NCCL, one
rank a GPU.

    python3 scripts/torch_sp_multigpu.py

Over four visible GPUs (or a multiple of four), each line beside the card's
name and power limit:

- ``[spn-slice]``: chip_smoke.py's [sp-slice] at data 2 x seq 2, data 1 x
  seq 4 and data 1 x seq 2 x model 2: the flagship at full width (fp32
  with its CTC loss in fp32 and in float64, then bf16), Transducer Small in
  fp32, and the flagship's fp32 step at a length where no point of the
  encoder splits, one step of 2 microbatches of 4 ragged utterances of 4-8 s
  a data rank padded by sp_pad_align, against the one-process step over the
  global batch on the first GPU at [sp-slice]'s gates; the ranks'
  parameters bit for bit equal, a rank's kernel launches, the seq (and
  model) groups' collectives a step and each rank's peak memory.
- ``[spn-rate]``: the flagship's own bf16 step (chip_smoke.py's
  [train-rate]: 2 x 32 utterances of 16 s a data rank, padded by
  sp_pad_align) at data 2 x seq 2 and data 1 x seq 4: ms a step (the
  slowest rank's mean of 5 steps after 2), audio-s/s and each rank's peak
  memory, beside one process on the first GPU at the same padded length. A
  reading; nothing is claimed from it.
- ``[spn-long]``: one bf16 step of 4 utterances of the sp_pad_align-ed
  length nearest 64 s (1,028,800 samples: 3,216 frames after subsampling)
  at data 1 x seq 4 and in one process (seq 1): each rank's peak memory and
  ms a step (the mean of 3 steps after 1). Memory is what sequence
  parallelism buys: the encoder's activations a rank fall to a quarter,
  beside the replicated frontend, subsampling input and heads.

Imports nothing of JAX; exits non-zero without a GPU. Rehearse it on the
CPU as chip_smoke.py's phases are (a copy with "cuda" made "cpu" and a
narrowed config).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402
from efficientconformer_torch.parallel import mesh  # noqa: E402

TIMEOUT = 900          # seconds for each launch of the ranks
LONG_SECONDS = 64.0    # [spn-long]'s utterances, before sp_pad_align
LONG_BATCH = 4


def step_rank(cfg: dict, seq: int, batch_size: int, samples: int, accum: int, steps: int,
              warmup: int) -> list:
    """In a rank (or one process, ``seq`` 1): ms a step over ``steps`` steps
    after ``warmup``, on an ``accum`` x ``batch_size`` x ``samples`` batch
    of full-length utterances seeded by the data rank, and the peak memory
    allocated over the timed steps."""
    from efficientconformer_torch.training.trainer import Trainer

    cfg = json.loads(json.dumps(cfg))
    cfg["training_params"]["seq_parallel"] = seq
    trainer = Trainer(cfg, seed=C.SEED)
    batch = C.train_batch(accum, batch_size, samples / C.SAMPLE_RATE, [80], trainer.device,
                          np.random.default_rng(C.SEED + 4 + mesh.data_rank()))
    for _ in range(warmup):
        trainer.train_step(batch)
    torch.cuda.synchronize(trainer.device)
    torch.cuda.reset_peak_memory_stats(trainer.device)
    t0 = time.perf_counter()
    for _ in range(steps):
        loss, _ = trainer.train_step(batch)
    torch.cuda.synchronize(trainer.device)
    ms = (time.perf_counter() - t0) * 1e3 / steps
    C.check(np.isfinite(float(loss)), f"[spn] loss {float(loss)}")
    return [ms, torch.cuda.max_memory_allocated(trainer.device), tuple(batch["audio"].shape)]


def gib(nbytes: int) -> str:
    return f"{nbytes / 2**30:.3f}"


def rate_check(n: int, card: str) -> None:
    cfg = C.train_config()
    tp = cfg["training_params"]
    for seq in (2, 4):
        samples = mesh.sp_pad_align(cfg["encoder_params"], seq)(tp["train_audio_max_length"])
        args = (cfg, seq, tp["batch_size"], samples, tp["accumulated_steps"], 5, 2)
        one = step_rank(cfg, 1, *args[2:])
        ranks = mesh.launch(step_rank, n, args, timeout=TIMEOUT)
        ms = max(r[0] for r in ranks)
        data, shape = n // seq, ranks[0][2]
        audio = shape[0] * shape[1] * shape[2] / C.SAMPLE_RATE
        C.say("spn-rate", ranks=n, grid=f"data{data}xseq{seq}", backend="nccl",
              dtype="bfloat16", per_data_rank_batch=shape, ms_per_step=f"{ms:.2f}",
              rank_ms=[f"{r[0]:.2f}" for r in ranks], one_process_ms=f"{one[0]:.2f}",
              audio_s_per_s=f"{data * audio / ms * 1e3:.1f}",
              one_process_audio_s_per_s=f"{audio / one[0] * 1e3:.1f}",
              peak_gib_per_rank=[gib(r[1]) for r in ranks], peak_gib_one_process=gib(one[1]),
              card=f"'{card}'")


def long_check(n: int, card: str) -> None:
    cfg = C.train_config()
    seq = 4
    samples = mesh.sp_pad_align(cfg["encoder_params"], seq)(round(LONG_SECONDS * C.SAMPLE_RATE))
    args = (cfg, seq, LONG_BATCH, samples, 1, 3, 1)
    one = step_rank(cfg, 1, *args[2:])
    ranks = mesh.launch(step_rank, seq, args, timeout=TIMEOUT)
    frames = mesh.seq_frame_schedule(cfg["encoder_params"], samples)
    C.say("spn-long", ranks=seq, grid=f"data1xseq{seq}", backend="nccl", dtype="bfloat16",
          batch=(1, LONG_BATCH, samples), seconds=samples / C.SAMPLE_RATE,
          frames=sorted(set(frames[1:]), reverse=True),
          ms_per_step=f"{max(r[0] for r in ranks):.2f}", one_process_ms=f"{one[0]:.2f}",
          peak_gib_per_rank=[gib(r[1]) for r in ranks], peak_gib_one_process=gib(one[1]),
          peak_ratio=f"{max(r[1] for r in ranks) / one[1]:.3f}", card=f"'{card}'")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_sp_multigpu: no CUDA device")
    n, card = torch.cuda.device_count(), C.card()
    print(card, flush=True)
    if n % 4:
        raise SystemExit(f"torch_sp_multigpu: {n} GPUs; it runs on a multiple of four")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # every kernel built once here, before the ranks load them
    from efficientconformer_torch.ops import _kernels, bias_attention, rel_attention, rnnt_loss

    for name in (rel_attention.KERNEL, rel_attention.KERNEL_BWD, rnnt_loss.KERNEL_FWD,
                 rnnt_loss.KERNEL_BWD, bias_attention.KERNEL, bias_attention.KERNEL_BWD):
        _kernels.build(name)
    C.say("spn", ranks=n, kind=torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    for seq, model in ((2, 1), (4, 1), (2, 2)):
        C.phase_sp_slice(card, n, seq, model, backend=None, phase="spn-slice")
    rate_check(n, card)
    long_check(n, card)
    C.say("spn-done", seconds=f"{time.perf_counter() - t0:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
