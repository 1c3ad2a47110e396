#!/usr/bin/env python3
"""Where DistributedDataParallel's own time goes on the flagship's step, on
one NVIDIA GPU.

    python3 scripts/torch_ddp_probe.py

One rank over NCCL, EfficientConformerCTCSmall's own bf16 step
(chip_smoke.py's [train-rate] batch: 2 x 32 x 16 s). The step without DDP
and through DDP (``find_unused_parameters``, as the Trainer wraps it), in
turns (plain, DDP, DDP, plain), 5 steps each: host ms a step. Then each
profiled over 3 steps with torch.profiler: device ms a step (CUDA kernels
and copies), and the CPU ops whose self time DDP adds, by name. Prints one
line per measurement and the card's name and power limit.

Imports nothing of JAX; exits non-zero without a GPU.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS = 5
PROFILED = 3


def step_ms(trainer, batch, steps) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def profile(trainer, batch) -> tuple[float, dict]:
    """(device ms a step, self CPU ms a step by op name) over PROFILED steps."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PROFILED):
            trainer.train_step(batch)
        torch.cuda.synchronize()
    rows = prof.key_averages()
    device = sum(e.self_device_time_total for e in rows
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)) / 1e3 / PROFILED
    cpu = {e.key: e.self_cpu_time_total / 1e3 / PROFILED for e in rows
           if e.device_type == torch.autograd.DeviceType.CPU}
    return device, cpu


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_ddp_probe: no CUDA device")
    import chip_smoke as C
    from efficientconformer_torch.parallel import mesh
    from efficientconformer_torch.training.trainer import Trainer

    card = C.card()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = C.train_config()
    tp = cfg["training_params"]
    batch = C.train_batch(tp["accumulated_steps"], tp["batch_size"],
                          tp["train_audio_max_length"] / C.SAMPLE_RATE, [80], "cuda",
                          np.random.default_rng(C.SEED + 4))
    with mesh.process_group(0, 1, "cuda"):
        trainers = {"plain": Trainer(cfg, device="cuda", seed=C.SEED, ddp=False),
                    "ddp": Trainer(cfg, device="cuda", seed=C.SEED, ddp=True)}
        for t in trainers.values():
            step_ms(t, batch, 2)
        ms = {"plain": [], "ddp": []}
        for name in ("plain", "ddp", "ddp", "plain"):
            ms[name].append(step_ms(trainers[name], batch, STEPS))
        for name, runs in ms.items():
            C.say("ddp-probe-time", path=name, ms_per_step=[f"{x:.2f}" for x in runs],
                  mean=f"{sum(runs) / len(runs):.2f}", card=f"'{card}'")
        prof = {name: profile(t, batch) for name, t in trainers.items()}
    for name, (device, cpu) in prof.items():
        C.say("ddp-probe-profile", path=name, device_ms_per_step=f"{device:.2f}",
              cpu_self_ms_per_step=f"{sum(cpu.values()):.2f}")
    plain_cpu, ddp_cpu = prof["plain"][1], prof["ddp"][1]
    added = sorted(((v - plain_cpu.get(k, 0.0), k) for k, v in ddp_cpu.items()), reverse=True)
    for extra, key in added[:12]:
        print(f"  +{extra:8.3f} ms self CPU a step  {key[:100]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
