#!/usr/bin/env python3
"""Tensor parallelism across GPUs: the port's model groups over NCCL, one
rank a GPU.

    python3 scripts/torch_tp_multigpu.py

Over four visible GPUs (or any count that 4 and 2 divide), each line beside
the card's name and power limit:

- ``[tpn-slice]``: chip_smoke.py's [tp-slice] at data 2 x model 2 and at
  data 1 x model 4 (one head a rank in the flagship's stages): the flagship
  at full width, fp32 then bf16, and the LM-Transformer in fp32, one step
  of 2 microbatches against the one-process step over the global batch on
  the first GPU at [dp-slice]'s gates (loss and gradient norm within 1e-5,
  parameters and BatchNorm statistics within 1e-4 in fp32; everything
  within 2e-2 in bf16), the replicated parameters bit for bit equal across
  the ranks, the kernels' launches a rank and the model groups' collectives
  a step.
- ``[tpn-rate]``: the flagship's own bf16 step (chip_smoke.py's
  [train-rate]: 2 x 32 x 16 s a data rank) at data 2 x model 2 and data 1 x
  model 4: ms a step (the slowest rank's mean of 5 steps after 2) beside one
  process on the first GPU; and the gather path's extra all-gathers in the
  grouped stage (q, k, v and the heads' output forward, their slices'
  gradients backward: 8 a layer and a microbatch at (32, 801, 120)), timed
  alone at those shapes over the model group. A reading beside
  scripts/torch_dp_multigpu.py's [dpn-rate]; nothing is claimed from it.
- ``[tpn-cli]``: ``python -m efficientconformer_torch.main -m training
  --model_parallel 2`` spawning one rank a GPU (data n/2 x model 2) on a
  synthetic LibriSpeech tree (chip_smoke.py's [cli-data]): one epoch of 2
  steps with validation, one epoch line and one checkpoint (the full
  layout); its test-clean WER with --model_parallel 2 and in one process.

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

TIMEOUT = 900      # seconds for each launch of the ranks
GATHER_ITERS = 20


def grouped_gathers(cfg: dict, model_parallel: int) -> dict:
    """The gather path's extra all-gathers of one step in the grouped stage,
    timed alone over this rank's model group at their shapes (bf16): 8 a
    layer and a microbatch of (B, T, D/n) each (T the stage's frames at the
    batch's 16 s)."""
    from efficientconformer_torch.config import resolve_block_configs
    from efficientconformer_torch.parallel import tensor

    p, tp = cfg["encoder_params"], cfg["training_params"]
    layers = [b for b in resolve_block_configs(p) if b.att_group_size > 1]
    shapes = C.stage_shapes(p, tp["train_audio_max_length"] / C.SAMPLE_RATE)
    name, n, dh, d, h, g = shapes[0]
    frames = n * g
    reg = tensor.region()
    x = torch.randn(tp["batch_size"], frames, d // model_parallel, device="cuda",
                    dtype=torch.bfloat16)
    for _ in range(3):
        tensor.all_gather(x, reg, -1)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(GATHER_ITERS):
        tensor.all_gather(x, reg, -1)
    end.record()
    torch.cuda.synchronize()
    one = start.elapsed_time(end) / GATHER_ITERS
    count = 8 * len(layers) * tp["accumulated_steps"]
    return {"shape": (tp["batch_size"], frames, d), "layers": len(layers),
            "gathers_per_step": count, "ms_per_gather": one, "ms_per_step": one * count}


def rate_rank(cfg: dict, model_parallel: int) -> list:
    """In a rank (or one process): the step's ms over 5 steps after 2, on
    a 2 x B x T batch seeded by the data rank; the batch's shape; under
    tensor parallelism the grouped stage's gathers timed alone."""
    from efficientconformer_torch.training.trainer import Trainer

    cfg = json.loads(json.dumps(cfg))
    cfg["training_params"]["model_parallel"] = model_parallel
    tp = cfg["training_params"]
    trainer = Trainer(cfg, seed=C.SEED)
    batch = C.train_batch(tp["accumulated_steps"], tp["batch_size"],
                          tp["train_audio_max_length"] / C.SAMPLE_RATE, [80], trainer.device,
                          np.random.default_rng(C.SEED + 4 + mesh.data_rank()))
    for _ in range(2):
        trainer.train_step(batch)
    torch.cuda.synchronize(trainer.device)
    t0 = time.perf_counter()
    for _ in range(5):
        loss, _ = trainer.train_step(batch)
    torch.cuda.synchronize(trainer.device)
    ms = (time.perf_counter() - t0) * 1e3 / 5
    C.check(np.isfinite(float(loss)), f"[tpn-rate] loss {float(loss)}")
    gathers = grouped_gathers(cfg, model_parallel) if model_parallel > 1 else None
    return [ms, tuple(batch["audio"].shape), gathers]


def rate_check(n, card):
    cfg = C.train_config()
    one, shape, _ = rate_rank(cfg, 1)
    for model_parallel in (2, 4):
        if n % model_parallel:
            continue
        ranks = mesh.launch(rate_rank, n, (cfg, model_parallel), timeout=TIMEOUT)
        ms = max(r[0] for r in ranks)
        data = n // model_parallel
        audio_s = data * shape[0] * shape[1] * shape[2] / C.SAMPLE_RATE
        gathers = ranks[0][2]
        C.say("tpn-rate", ranks=n, grid=f"data{data}xmodel{model_parallel}", backend="nccl",
              dtype="bfloat16", per_data_rank_batch=shape, ms_per_step=f"{ms:.2f}",
              rank_ms=[f"{r[0]:.2f}" for r in ranks], one_process_ms=f"{one:.2f}",
              audio_s_per_s=f"{audio_s / ms * 1e3:.1f}",
              one_process_audio_s_per_s=f"{shape[0] * shape[1] * shape[2] / C.SAMPLE_RATE / one * 1e3:.1f}",
              grouped_gathers_shape=gathers["shape"], grouped_layers=gathers["layers"],
              grouped_gathers_per_step=gathers["gathers_per_step"],
              ms_per_gather=f"{gathers['ms_per_gather']:.4f}",
              grouped_gathers_ms_per_step=f"{gathers['ms_per_step']:.2f}", card=f"'{card}'")


def cli_check(n, card):
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"), prefix="tpn_") as tmp:
        C.phase_cli_data(tmp)
        path = C.cli_config(C.CONFIG, tmp, "ctc", 1)
        with open(path) as f:
            cfg = json.load(f)
        cfg["training_params"]["batch_size"] = 8 * (n // 2)
        with open(path, "w") as f:
            json.dump(cfg, f)
        base = [sys.executable, "-m", "efficientconformer_torch.main", "-c", path]

        def cli(*args):
            res = subprocess.run(base + [str(a) for a in args], cwd=ROOT, capture_output=True,
                                 text=True, timeout=TIMEOUT)
            C.check(res.returncode == 0, f"[tpn-cli] {args}: {res.stdout[-2000:]}"
                                         f"{res.stderr[-3000:]}")
            return res.stdout

        t0 = time.perf_counter()
        out = cli("-m", "training", "--model_parallel", 2, "--create_tokenizer", "-p",
                  "--steps_per_epoch", 2, "--val_steps", 1)
        train_s = time.perf_counter() - t0
        epochs = C.epoch_lines(out)
        C.check([e[:1] + e[2:3] for e in epochs] == [(1, 2)], f"[tpn-cli] epochs {epochs}")
        C.check(out.count("Model Parameters :") == 1 and len(re.findall(r"val: \{", out)) == 1,
                f"[tpn-cli] rank 0 alone prints: {out[-2000:]}")
        cb = cfg["training_params"]["callback_path"]
        ckpts = sorted(f for f in os.listdir(cb) if f.endswith(".ckpt"))
        C.check(ckpts == ["checkpoints_1.ckpt"], f"[tpn-cli] checkpoints {ckpts}")
        wers = [re.search(r"Greedy Search WER : ([\d.]+)%", cli(
            "-m", "test-clean", "-i", 1, "--gready", *flags)).group(1)
            for flags in (("--model_parallel", 2), ())]
        C.check(wers[0] == wers[1], f"[tpn-cli] test-clean WER {wers}")
        C.say("tpn-cli", ranks=n, grid=f"data{n // 2}xmodel2", backend="nccl",
              train_seconds=f"{train_s:.2f}", epochs=[(e, f"{x:.4f}", s) for e, x, s, _ in epochs],
              ms_per_step=epochs[0][3], test_wer_model_parallel=wers[0],
              test_wer_one_process=wers[1], card=f"'{card}'")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_tp_multigpu: no CUDA device")
    n, card = torch.cuda.device_count(), C.card()
    print(card, flush=True)
    if n % 4:
        raise SystemExit(f"torch_tp_multigpu: {n} GPUs; it runs on a multiple of four")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # every kernel built once here, before the ranks load them
    from efficientconformer_torch.ops import _kernels, bias_attention, rel_attention, rnnt_loss

    for name in (rel_attention.KERNEL, rel_attention.KERNEL_BWD, rnnt_loss.KERNEL_FWD,
                 rnnt_loss.KERNEL_BWD, bias_attention.KERNEL, bias_attention.KERNEL_BWD):
        _kernels.build(name)
    C.say("tpn", ranks=n, kind=torch.cuda.get_device_name(0))
    for model_parallel in (2, 4):
        C.phase_tp_slice(card, n, model_parallel, backend=None, phase="tpn-slice")
    rate_check(n, card)
    cli_check(n, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
