#!/usr/bin/env python3
"""Data parallelism across GPUs: the port's ranks over NCCL, one a GPU.

    python3 scripts/torch_dp_multigpu.py

Three checks over every visible GPU (N ranks over NCCL), each line beside
the card's name and power limit:

- ``[dpn-slice]``: chip_smoke.py's [dp-slice] at N ranks: the flagship at
  full width, fp32 then bf16, one step of 2 microbatches of 2 ragged
  utterances of 4-8 s a rank against the one-process step over the global
  batch on the first GPU (loss and gradient norm within 1e-5 and the
  parameters and BatchNorm statistics within 1e-4 in fp32, everything
  within 2e-2 in bf16), equal across the ranks, 15 / 15 rel-pos launches
  a microbatch.
- ``[dpn-rate]``: weak scaling of the flagship's own bf16 step
  (chip_smoke.py's [train-rate]: 2 x 32 x 16 s a rank): ms a step on N
  ranks (the slowest rank's mean of 5 steps after 2) beside one process
  without DDP on the first GPU, audio-s/s over all ranks, and the scaling
  efficiency (one process's ms over N ranks').
- ``[dpn-cli]``: ``python -m efficientconformer_torch.main -d`` spawning N
  ranks on a synthetic LibriSpeech tree (chip_smoke.py's [cli-data]):
  tokenizer and manifests written by rank 0, one epoch of 2 steps with
  validation, one epoch line and one checkpoint; the checkpoint's
  test-clean WER with -d and in one process.

Imports nothing of JAX; exits non-zero without a GPU. Rehearse it on the
CPU as chip_smoke.py's phases are (a copy with "cuda" made "cpu" and a
narrowed config).
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402
from efficientconformer_torch.parallel import mesh  # noqa: E402

TIMEOUT = 600      # seconds for each launch of the ranks


def rate_rank(cfg: dict) -> list:
    """In a rank (or one process): the step's ms over 5 steps after 2, on
    a 2 x B x T batch seeded by the rank, and the batch's shape."""
    from efficientconformer_torch.training.trainer import Trainer

    tp = cfg["training_params"]
    trainer = Trainer(cfg, seed=C.SEED)
    batch = C.train_batch(tp["accumulated_steps"], tp["batch_size"],
                          tp["train_audio_max_length"] / C.SAMPLE_RATE, [80], trainer.device,
                          np.random.default_rng(C.SEED + 4 + mesh.rank()))
    for _ in range(2):
        trainer.train_step(batch)
    torch.cuda.synchronize(trainer.device)
    t0 = time.perf_counter()
    for _ in range(5):
        trainer.train_step(batch)
    torch.cuda.synchronize(trainer.device)
    return [(time.perf_counter() - t0) * 1e3 / 5, tuple(batch["audio"].shape)]


def rate_check(n, card):
    cfg = C.train_config()
    ranks = mesh.launch(rate_rank, n, (cfg,), timeout=TIMEOUT)
    one, shape = rate_rank(cfg)
    ms = max(r[0] for r in ranks)
    audio_s = n * shape[0] * shape[1] * shape[2] / C.SAMPLE_RATE
    C.say("dpn-rate", ranks=n, backend="nccl", dtype="bfloat16",
          per_rank_batch=shape, ms_per_step=f"{ms:.2f}",
          rank_ms=[f"{r[0]:.2f}" for r in ranks], one_process_ms=f"{one:.2f}",
          audio_s_per_s=f"{audio_s / ms * 1e3:.1f}",
          one_process_audio_s_per_s=f"{audio_s / n / one * 1e3:.1f}",
          scaling_efficiency=f"{one / ms:.3f}", card=f"'{card}'")


def cli_check(n, card):
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"), prefix="dpn_") as tmp:
        C.phase_cli_data(tmp)
        path = C.cli_config(C.CONFIG, tmp, "ctc", 1)
        with open(path) as f:
            cfg = json.load(f)
        cfg["training_params"]["batch_size"] = 8 * n
        with open(path, "w") as f:
            json.dump(cfg, f)
        base = [sys.executable, "-m", "efficientconformer_torch.main", "-c", path]

        def cli(*args):
            res = subprocess.run(base + [str(a) for a in args], cwd=ROOT, capture_output=True,
                                 text=True, timeout=TIMEOUT)
            C.check(res.returncode == 0, f"[dpn-cli] {args}: {res.stdout[-2000:]}"
                                         f"{res.stderr[-3000:]}")
            return res.stdout

        t0 = time.perf_counter()
        out = cli("-m", "training", "-d", "--world_size", n, "--create_tokenizer", "-p",
                  "--steps_per_epoch", 2, "--val_steps", 1)
        train_s = time.perf_counter() - t0
        epochs = C.epoch_lines(out)
        C.check([e[:1] + e[2:3] for e in epochs] == [(1, 2)], f"[dpn-cli] epochs {epochs}")
        C.check(out.count("Model Parameters :") == 1 and len(re.findall(r"val: \{", out)) == 1,
                f"[dpn-cli] rank 0 alone prints: {out[-2000:]}")
        cb = cfg["training_params"]["callback_path"]
        ckpts = sorted(f for f in os.listdir(cb) if f.endswith(".ckpt"))
        C.check(ckpts == ["checkpoints_1.ckpt"], f"[dpn-cli] checkpoints {ckpts}")
        wers = [re.search(r"Greedy Search WER : ([\d.]+)%", cli(
            "-m", "test-clean", "-i", 1, "--gready", *flags)).group(1)
            for flags in (("-d", "--world_size", n), ())]
        C.check(wers[0] == wers[1], f"[dpn-cli] test-clean WER {wers}")
        C.say("dpn-cli", ranks=n, backend="nccl",
              train_seconds=f"{train_s:.2f}", epochs=[(e, f"{x:.4f}", s) for e, x, s, _ in epochs],
              ms_per_step=epochs[0][3], test_wer_dp=wers[0], test_wer_one_process=wers[1],
              card=f"'{card}'")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_dp_multigpu: no CUDA device")
    n, card = torch.cuda.device_count(), C.card()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # every kernel built once here, before the ranks load them
    from efficientconformer_torch.ops import _kernels, bias_attention, rel_attention, rnnt_loss

    for name in (rel_attention.KERNEL, rel_attention.KERNEL_BWD, rnnt_loss.KERNEL_FWD,
                 rnnt_loss.KERNEL_BWD, bias_attention.KERNEL, bias_attention.KERNEL_BWD):
        _kernels.build(name)
    C.say("dpn", ranks=n, kind=torch.cuda.get_device_name(0))
    C.phase_dp_slice(card, n, backend=None, phase="dpn-slice")
    rate_check(n, card)
    cli_check(n, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
