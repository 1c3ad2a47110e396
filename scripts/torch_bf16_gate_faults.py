#!/usr/bin/env python3
"""Faults planted in one rel-pos backward call of a bf16 training step,
read by chip_smoke.py's gates of that step, on one NVIDIA GPU.

    python3 scripts/torch_bf16_gate_faults.py

For each encoder of chip_smoke.py's [wider-slice] (EfficientConformer CTC
Large at 4 heads, whose first and last layers take the wide routes, and
Conformer CTC Large at width 1,024), at [wider-slice]'s batch: the plain
versions' fp32 and bf16 steps, then the kernels' bf16 step clean and with
one fault planted in one call of the backward (call 1 is the last layer's:
the backward runs the layers in reverse): a column group of dqu, dk or dv
zeroed, or one head of ddelta or dW zeroed or scaled by 0.9. Prints, for
each, chip_smoke's per-parameter ratio (``leaf_gap``) and its worst
parameter, the global ratio (``grad_gap`` over the plain versions'), and
whether ``chip_smoke.check_step`` fails the step, with the card's name and
power limit.

Imports nothing of JAX; exits non-zero without a GPU.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# which gradient of (dqu, dk, dv, ddelta, dw, dbias) a fault changes, and how
FAULTS = {
    "dqu columns 0-15 zeroed": (0, lambda t: t[..., :16].zero_()),
    "dk columns 0-15 zeroed": (1, lambda t: t[..., :16].zero_()),
    "dv columns 0-15 zeroed": (2, lambda t: t[..., :16].zero_()),
    "ddelta head 0 zeroed": (3, lambda t: t[0].zero_()),
    "ddelta head 0 x 0.9": (3, lambda t: t[0].mul_(0.9)),
    "dW head 0 zeroed": (4, lambda t: t[0].zero_()),
    "dW head 0 x 0.9": (4, lambda t: t[0].mul_(0.9)),
}
CALLS = {"EfficientConformerCTCLarge_heads4": (1, 16), "ConformerCTCLarge_width1024": (1,)}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_bf16_gate_faults: no CUDA device")
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from efficientconformer_torch.ops import _kernels, rel_attention as RA

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = C.card()
    print(card, flush=True)
    for name in (RA.KERNEL, RA.KERNEL_BWD):
        _kernels.build(name)
        _kernels.load(name)
    launch_bwd = RA._launch_bwd
    for i, model in enumerate(C.WIDER_MODELS):
        cfg, enc = C.wider_encoder(model)
        enc.update(Pdrop=0.0, spec_augment=False)
        batch = C.train_batch(1, len(C.WIDE_FP32_SECONDS), [C.WIDE_FP32_SECONDS], [60, 30], "cpu",
                              np.random.default_rng(C.SEED + 140 + i))
        steps = {}
        for bf16 in (False, True):
            c = json.loads(json.dumps(cfg))
            c["training_params"]["mixed_precision"] = bf16
            steps[bf16] = (c, C.one_step(c, "cuda", batch, plain=True))
        fp32, (c16, plain) = steps[False][1][2], steps[True]
        runs = [("clean", None)] + [(f, call) for call in CALLS[model] for f in FAULTS]
        for fault, call in runs:
            calls = [0]

            def faulty(*args, fault=fault, call=call):
                grads = list(launch_bwd(*args))
                calls[0] += 1
                if calls[0] == call:
                    which, plant = FAULTS[fault]
                    plant(grads[which])
                return tuple(grads)

            RA._launch_bwd = faulty
            try:
                kernel = C.one_step(c16, "cuda", batch)
            finally:
                RA._launch_bwd = launch_bwd
            leaf, worst, zero = C.leaf_gap(kernel[2], plain[2], fp32)
            ratio = C.grad_gap(kernel[2], fp32) / C.grad_gap(plain[2], fp32)
            out = {"loss_rel": abs(kernel[0] - plain[0]) / abs(plain[0]),
                   "norm_rel": abs(kernel[1] - plain[1]) / abs(plain[1]),
                   "grad_rel": C.rel_diff(kernel[2], plain[2]),
                   "stats_rel": C.rel_diff(kernel[3], plain[3]), "kernel": kernel, "plain": plain}
            try:
                C.check_step("bf16-gate-fault", model, torch.bfloat16, out, fp32)
                verdict = "passes"
            except RuntimeError:
                verdict = "fails"
            C.say("bf16-gate-fault", model=model, call=call or "-", fault=f"'{fault}'",
                  leaf_gap=f"{leaf:.3g}", leaf=worst, leaves_zero=zero,
                  global_ratio=f"{ratio:.3g}", gate=verdict, card=f"'{card}'")
    return 0


if __name__ == "__main__":
    sys.exit(main())
