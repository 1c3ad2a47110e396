#!/usr/bin/env python3
"""Device-time probe of the PyTorch port's bias-attention kernels, and an
A/B of the LM, CTC or RNN-T paths, or of the bias kernels past a head
width of 256, between two checkouts, on one NVIDIA GPU.

    python3 scripts/torch_bias_attention_probe.py probe
    python3 scripts/torch_bias_attention_probe.py ab PARENT_DIR [CHANGE_DIR] [--ctc | --rnnt | --widest]

``probe`` times the bias attention's forward and backward at the
LM-Transformer's training shape (B 64, H 12, N 101, dh 64, bf16, the causal
fp32 bias) by torch.profiler's device time per kernel name, beside
scaled_dot_product_attention (the bias as a bf16 mask), and at N 256 and
1024 the useful TFLOP/s of the kernels and of SDPA without a mask.

``ab`` runs chip_smoke.py's LM phases (lm-score-rate, lm-train-rate), a
device-time profile of one scoring batch and one training step, and the bias
kernels' timed phases up to a width of 256 (lm-kernel-time, wide-kernel-time
at widths 135 and 256, stream-kernel-time) in each
checkout, in turns (parent, change, change, parent), each in its own
process from the checkout's root, so that both are measured on the same
card within one call; with ``--ctc`` the CTC flagship's phases (rate,
train-rate) and profiles of one inference batch and one training step
instead, with the rel-pos kernels' profile rows; with ``--rnnt`` the RNN-T
lattice kernels' training step first (t-train-rate), then their phase
(rnnt-kernel) and both kernels' device time from a CUDA graph
(``[rnnt-ab]``, the same measure in both checkouts) at the Transducer's
training shape and at U+1 1024, the widest lattice of one thread a label
position; with ``--widest`` the bias kernels past a head width of 256:
widest-kernel (its checks, then [widest-kernel-time]: every width at the
causal 4-head Large's serving window and training step, both types and
directions, beside the plain version, SDPA and the bound) and
causal-wide-slice (that model's fp32 and bf16 steps and streams, ms a step
and a window step), then the bias kernels' timed phases up to 256 as
``ab`` runs them. Make the parent's checkout with
``git archive <commit> | tar -x -C build/parent``.

Imports nothing of JAX; exits non-zero without a GPU.
"""

from __future__ import annotations

import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

AB_PHASES = """
import torch, chip_smoke as C
card = C.card()
print(card, flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
C.phase_lm_score_rate(card)
C.phase_lm_train_rate(card)
trainer, batch = C.lm_rate_trainer()
step = lambda: trainer.train_step(batch)
C.profile("lm-train", step, C.wall_ms(step))
scorer, mb = C.lm_score_setup()
score = lambda: scorer.eval_loss(mb)
C.profile("lm-score", score, C.wall_ms(score))
C.phase_lm_kernel()
C.phase_wide_kernel()
C.phase_stream_kernel()
"""

AB_PHASES_CTC = """
import numpy as np, torch, chip_smoke as C
from efficientconformer_torch.models.model_ctc import greedy_decode
card = C.card()
print(card, flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
C.phase_rate(card)
C.phase_train_rate(card)
trainer, batch = C.rate_trainer()
step = lambda: trainer.train_step(batch)
C.profile("train", step, C.wall_ms(step))
model = C.make_model("cuda", torch.bfloat16)
n = int(C.TIME_SECONDS * C.SAMPLE_RATE)
x = torch.from_numpy((np.random.default_rng(0).standard_normal((C.TIME_BATCH, n)) * 0.1)
                     .astype(np.float32)).cuda()
x_len = torch.full((C.TIME_BATCH,), n, device="cuda")
infer = lambda: greedy_decode(model, x, x_len)
C.profile("infer", infer, C.wall_ms(infer))
"""

AB_PHASES_RNNT = """
import concurrent.futures, torch, chip_smoke as C
from efficientconformer_torch.config import encoder_output_frames, load_config
from efficientconformer_torch.ops import _kernels, rel_attention as RA, rnnt_loss as RL
card = C.card()
print(card, flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
names = (RA.KERNEL, RA.KERNEL_BWD, RL.KERNEL_FWD, RL.KERNEL_BWD)
with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
    list(pool.map(_kernels.build, names))
C.phase_t_train_rate(card)   # first, before any CUDA graph of the kernel phase
cfg = load_config(C.T_CONFIG)
C.phase_rnnt_kernel(cfg)
tp = cfg["training_params"]
t = encoder_output_frames(cfg["encoder_params"], tp["train_audio_max_length"])
for u1 in (tp["train_label_max_length"] + 1, 1024):   # training; one thread a position
    blank, emit, f_len, y_len = C.rnnt_inputs(tp["batch_size"], t, u1, C.SEED + 6)
    alphas, loss = RL.rnnt_alphas(blank, emit, f_len, y_len)
    fwd = lambda: RL.rnnt_alphas(blank, emit, f_len, y_len)
    bwd = lambda: RL.rnnt_grads(blank, emit, alphas, f_len, y_len, -loss)
    print(f"[rnnt-ab] shape={tuple(blank.shape)} fwd_graph_ms={C.graph_ms(fwd):.4f} "
          f"bwd_graph_ms={C.graph_ms(bwd):.4f} fwd_eager_ms={C.cuda_ms(fwd):.4f} "
          f"bwd_eager_ms={C.cuda_ms(bwd):.4f}", flush=True)
"""


AB_PHASES_WIDEST = """
import concurrent.futures, torch, chip_smoke as C
from efficientconformer_torch.ops import _kernels, bias_attention as BA
card = C.card()
print(card, flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
with concurrent.futures.ThreadPoolExecutor(2) as pool:
    list(pool.map(_kernels.build, (BA.KERNEL, BA.KERNEL_BWD)))
C.phase_widest_kernel()
C.phase_causal_wide_slice(card)
C.phase_lm_kernel()
C.phase_wide_kernel()
C.phase_stream_kernel()
"""


def device_ms(fn, iters: int = 30) -> dict[str, float]:
    """Device ms per call of ``fn`` by kernel name (torch.profiler)."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("((")[0].split("::")[-1]: e.self_device_time_total / iters / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}


def probe() -> None:
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, str(ROOT))
    from efficientconformer_torch.ops import bias_attention as BA

    def say(label, times, flops=None):
        total = sum(times.values())
        rate = f" {flops / total / 1e9:.1f} TFLOP/s useful" if flops else ""
        parts = " ".join(f"{k}={v:.4f}" for k, v in times.items())
        print(f"[probe] {label}: {parts} total_ms={total:.4f}{rate}", flush=True)

    for b, h, n, d in ((64, 12, 101, 64), (16, 12, 256, 64), (4, 12, 1024, 64)):
        gen = torch.Generator().manual_seed(0)

        def heads(rows):
            return torch.randn(b, rows, h, d, generator=gen).cuda().bfloat16().transpose(1, 2)

        q, k, v = heads(n), heads(n), heads(n)
        causal = torch.triu(torch.full((n, n), -1e9), 1)
        bias = (torch.randn(b, h, n, n, generator=gen) + causal).cuda()
        do = torch.randn(b, h, n, d, generator=gen).cuda().bfloat16()
        scale = 1.0 / math.sqrt(d)
        o, lse = BA.bias_attention_fwd(q, k, v, bias, scale)
        flops = 4 * b * h * n * n * d
        shape = f"B{b} H{h} N{n} dh{d}"
        say(f"{shape} forward", device_ms(lambda: BA.bias_attention_fwd(q, k, v, bias, scale)),
            flops)
        say(f"{shape} backward",
            device_ms(lambda: BA.bias_attention_bwd(q, k, v, bias, o, do, lse, scale)),
            2.5 * flops)
        if n == 101:
            mask = bias.bfloat16()
            say(f"{shape} sdpa forward, bf16 mask", device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)))
        else:
            say(f"{shape} sdpa forward, no mask", device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)), flops)


def ab(parent: str, change: str, phases: str = AB_PHASES, kernels: str = "bias_",
       width: int = 240) -> int:
    """``phases`` (Python run from each checkout's root) in parent, change,
    change, parent; prints the phase lines, the card and the profile rows
    that name ``kernels``, each cut to ``width`` characters."""
    failed = 0
    for label, where in (("parent", parent), ("change", change), ("change", change),
                         ("parent", parent)):
        print(f"==== {label}: {where}", flush=True)
        res = subprocess.run([sys.executable, "-c", phases], cwd=where, capture_output=True,
                             text=True, check=False)
        for line in res.stdout.splitlines():
            if line.startswith(("[", "NVIDIA")) or kernels in line:
                print(line[:width], flush=True)
        if res.returncode:
            print(res.stderr[-3000:], flush=True)
            failed = 1
    return failed


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_bias_attention_probe: no CUDA device")
    if len(sys.argv) >= 2 and sys.argv[1] == "probe":
        probe()
        return 0
    args = [a for a in sys.argv[1:] if a not in ("--ctc", "--rnnt", "--widest")]
    if len(args) >= 2 and args[0] == "ab":
        change = args[2] if len(args) > 2 else str(ROOT)
        if "--ctc" in sys.argv:
            return ab(args[1], change, AB_PHASES_CTC, "relpos_")
        if "--rnnt" in sys.argv:
            return ab(args[1], change, AB_PHASES_RNNT, "rnnt_")
        if "--widest" in sys.argv:
            return ab(args[1], change, AB_PHASES_WIDEST, "bias_", width=4000)
        return ab(args[1], change)
    raise SystemExit(__doc__)


if __name__ == "__main__":
    sys.exit(main())
