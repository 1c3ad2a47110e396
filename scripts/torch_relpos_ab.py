#!/usr/bin/env python3
"""The rel-pos attention kernels of two trees of this repository on one
NVIDIA GPU, in turns.

    git archive <commit> | tar -x -C build/parent
    python3 scripts/torch_relpos_ab.py [--other build/parent] [--turns 2]

Runs chip_smoke.py's [kernel] and [kernel-bwd] phases (the flagship's stage
shapes: the forward at b128 x 10 s, the backward at b32 x 16 s; each
direction checked against its plain version, then timed from CUDA graphs,
fp32 and bf16) in the other tree and in this one in turns (other, this,
this, other for two turns), each run in a process of its own from its own
tree, with its kernels built there first (both trees in parallel). Prints
each run's phase lines and, per run, the fp32 and bf16 ms summed over the
three stage shapes, with the card's name and power limit.

Imports nothing of JAX; exits non-zero without a GPU or when a run fails.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUN = """
import json, sys
sys.path.insert(0, '.')
import torch
import chip_smoke as C
from efficientconformer_torch.config import load_config
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
enc = load_config(C.CONFIG)['encoder_params']
_, _, fwd = C.phase_kernel(enc)
_, _, bwd = C.phase_kernel_bwd(enc)
print('RESULT', json.dumps({'fwd': fwd, 'bwd': bwd}), flush=True)
"""
BUILD = ("from efficientconformer_torch.ops import _kernels\n"
         "for name in ('rel_attention_fwd', 'rel_attention_bwd'):\n"
         "    _kernels.build(name)\n")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", default=os.path.join(ROOT, "build", "parent"),
                        help="the other tree (default: build/parent)")
    parser.add_argument("--turns", type=int, default=2,
                        help="pairs of runs, each pair other, this or this, other")
    opts = parser.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    trees = {"other": os.path.abspath(opts.other), "this": ROOT}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for done in pool.map(lambda tree: subprocess.run([sys.executable, "-c", BUILD], cwd=tree),
                             trees.values()):
            if done.returncode != 0:
                return done.returncode
    order = [("other", "this") if t % 2 == 0 else ("this", "other") for t in range(opts.turns)]
    rows = []
    for name in [n for pair in order for n in pair]:
        out = subprocess.run([sys.executable, "-c", RUN], cwd=trees[name], capture_output=True,
                             text=True)
        print(f"==== {name}: {trees[name]} (exit {out.returncode})", flush=True)
        print(out.stdout, out.stderr[-4000:], flush=True)
        if out.returncode != 0:
            return out.returncode
        result = json.loads(next(line for line in out.stdout.splitlines()
                                 if line.startswith("RESULT "))[7:])
        rows.append((name, result["fwd"]["kernel_fp32"], result["bwd"]["kernel_fp32"],
                     result["fwd"]["kernel"], result["bwd"]["kernel"]))
    for row in rows:
        print("[relpos-ab] tree=%s fp32_fwd_ms=%.4f fp32_bwd_ms=%.4f bf16_fwd_ms=%.4f "
              "bf16_bwd_ms=%.4f" % row + f" card='{card}'", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
