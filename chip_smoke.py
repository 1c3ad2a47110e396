#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives the port's main path, batched greedy CTC inference of the flagship
configs/EfficientConformerCTCSmall.json at full width with seeded random
weights, and holds every hand-written kernel on that path to its plain
PyTorch version on the card. Phases, one line each; any failure exits
non-zero:

  1. device   CUDA present; card name and power limit; TF32 off
  2. build    the kernels, from the sources in this checkout
  3. kernel   each kernel vs its plain version at the main path's shapes
              (10 s of audio, batch 8, ragged key masks), fp32 and bf16;
              then kernel and plain timed at batch 128
  4. requests a ragged batch (2.5 s, 6 s, 10 s) decoded through
              greedy_decode in bf16; the kernel must launch 15 times
  5. slice    full-width fp32 logits of that batch through the kernel vs
              through the plain version on the card, and vs the CPU
  6. rate     batch 128 x 10 s greedy decode in bf16: audio-s/s

Then one JSON line with each kernel's launches, error and times, and last
{"ok": true, "device": {...}}. There is no CPU path: without a GPU the script
exits non-zero and prints no result. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

CONFIG = "configs/EfficientConformerCTCSmall.json"
SEED = 0
SAMPLE_RATE = 16000
REQUEST_SECONDS = (2.5, 6.0, 10.0)
CHECK_BATCH = 8
TIME_BATCH = 128
TIME_SECONDS = 10.0
KERNEL_FP32_TOL = 1e-4       # fp32 kernel vs fp32 plain: summation order only
KERNEL_BF16_TOL = 2e-2       # bf16 output rounding (8 mantissa bits) of O ~ 1
SLICE_TOL = 1e-3             # fp32 logits after 15 blocks
SLICE_ARGMAX_AGREEMENT = 0.999


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- inputs


def stage_shapes(enc_params: dict, seconds: float):
    """(name, N, dh, D, H, G) of the first attention layer of each stage at
    ``seconds`` of audio, as the encoder gives them."""
    from efficientconformer_torch.config import resolve_block_configs

    hop = enc_params["sample_rate"] * enc_params["hop_length_ms"] // 1000
    t = int(seconds * SAMPLE_RATE) // hop + 1
    for _ in range(enc_params["subsampling_layers"]):
        t = (t - 1) // 2 + 1
    shapes, seen = [], set()
    for blk in resolve_block_configs(enc_params):
        d, h, g = blk.dim_model, blk.num_heads, blk.att_group_size
        if (d, g) not in seen:
            seen.add((d, g))
            layout = "grouped" if g > 1 else "plain"
            shapes.append((f"D{d}_{layout}", -(-t // g), g * d // h, d, h, g))
        if blk.stride > 1:
            t = (t - 1) // blk.stride + 1
    return shapes


def attention_inputs(b, n, dh, d, h, g, device, gen):
    from efficientconformer_torch.ops import rel_factorize as RF
    from efficientconformer_torch.ops.attention import NEG_INF

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    qu, k, v = randn(b, h, n, dh), randn(b, h, n, dh), randn(b, h, n, dh)
    pos_kernel = randn(d, d, scale=d ** -0.5)
    delta = randn(h, dh, scale=0.1)
    if g > 1:
        w = RF.rel_w_grouped(h, dh, pos_kernel, g, d // 2)
    else:
        w = RF.rel_w_plain(pos_kernel, h, d // 2)
    rowtab, keytab = RF.rel_tables(n, n, d, g, torch.device(device))
    lengths = torch.linspace(n // 2, n, b).long()
    mask = (torch.arange(n)[None, :] >= lengths[:, None]).float()[:, None, None, :]
    bias = (mask * NEG_INF).to(device)
    return qu, k, v, delta, w, rowtab, keytab, bias, 1.0 / math.sqrt(dh)


def ragged_audio(seconds, device, rng):
    n = [int(s * SAMPLE_RATE) for s in seconds]
    x = (rng.standard_normal((len(n), max(n))) * 0.1).astype(np.float32)
    for i, ni in enumerate(n):
        x[i, ni:] = 0.0
    return torch.from_numpy(x).to(device), torch.tensor(n, device=device)


def make_model(device, dtype):
    """The flagship at full width, weights from SEED, with non-trivial
    norm parameters and BatchNorm running statistics."""
    from efficientconformer_torch.models.model_ctc import build_model

    model = build_model(CONFIG, device, dtype, torch.Generator().manual_seed(SEED))
    gen = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d, torch.nn.LayerNorm)):
                shape = m.weight.shape
                m.weight.copy_(1.0 + 0.1 * torch.randn(shape, generator=gen))
                m.bias.copy_(0.1 * torch.randn(shape, generator=gen))
                if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                    m.running_mean.copy_(0.2 * torch.randn(shape, generator=gen))
                    m.running_var.copy_(0.5 + torch.rand(shape, generator=gen))
    return model


# ---------------------------------------------------------------- phases


def phase_kernel(enc_params):
    from efficientconformer_torch.ops import rel_attention as RA

    gen = torch.Generator().manual_seed(SEED)
    shapes = stage_shapes(enc_params, TIME_SECONDS)
    max_err = 0.0
    for name, n, dh, d, h, g in shapes:
        args = attention_inputs(CHECK_BATCH, n, dh, d, h, g, "cuda", gen)
        o_k, lse_k = RA.relpos_attention(*args)
        o_p, lse_p = RA.reference_relpos_attention(*args)
        torch.cuda.synchronize()
        err_o = (o_k - o_p).abs().max().item()
        err_lse = (lse_k - lse_p).abs().max().item()
        check(err_o <= KERNEL_FP32_TOL and err_lse <= KERNEL_FP32_TOL,
              f"{name} fp32: |O| {err_o} |LSE| {err_lse} > {KERNEL_FP32_TOL}")
        qkv16 = [t.to(torch.bfloat16) for t in args[:3]]
        o_b, _ = RA.relpos_attention(*qkv16, *args[3:])
        o_bp, _ = RA.reference_relpos_attention(*[t.float() for t in qkv16], *args[3:])
        err_b = (o_b.float() - o_bp).abs().max().item()
        check(o_b.dtype == torch.bfloat16 and err_b <= KERNEL_BF16_TOL,
              f"{name} bf16: |O| {err_b} > {KERNEL_BF16_TOL}")
        max_err = max(max_err, err_o, err_lse)
        say("kernel", shape=name, B=CHECK_BATCH, N=n, dh=dh, D=d, H=h, G=g,
            fp32_err_o=f"{err_o:.3g}", fp32_err_lse=f"{err_lse:.3g}", bf16_err_o=f"{err_b:.3g}")

    times = {"kernel": 0.0, "plain": 0.0, "kernel_fp32": 0.0, "plain_fp32": 0.0}
    for name, n, dh, d, h, g in shapes:
        args = attention_inputs(TIME_BATCH, n, dh, d, h, g, "cuda", gen)
        args16 = [t.to(torch.bfloat16) for t in args[:3]] + list(args[3:])
        row = {}
        for label, fn, a in (("plain_fp32", RA.reference_relpos_attention, args),
                             ("kernel_fp32", RA.relpos_attention, args),
                             ("plain", RA.reference_relpos_attention, args16),
                             ("kernel", RA.relpos_attention, args16)):
            row[label] = cuda_ms(lambda: fn(*a))
            times[label] += row[label]
        say("kernel-time", shape=name, B=TIME_BATCH,
            **{f"{k}_ms": f"{v:.4f}" for k, v in row.items()})
    return max_err, times


def phase_requests():
    from efficientconformer_torch.config import encoder_output_frames, load_config
    from efficientconformer_torch.models.model_ctc import greedy_decode
    from efficientconformer_torch.ops import rel_attention as RA

    enc_params = load_config(CONFIG)["encoder_params"]
    model = make_model("cuda", torch.bfloat16)
    x, x_len = ragged_audio(REQUEST_SECONDS, "cuda", np.random.default_rng(SEED))
    RA.relpos_attention.launches = 0
    tokens, counts = greedy_decode(model, x, x_len)
    torch.cuda.synchronize()
    launches = RA.relpos_attention.launches
    n_att = len(model.encoder.blocks)
    check(launches == n_att, f"{launches} kernel launches for one forward, expected {n_att}")
    frames = [encoder_output_frames(enc_params, int(s * SAMPLE_RATE)) for s in REQUEST_SECONDS]
    counts = counts.tolist()
    check(all(0 <= c <= f for c, f in zip(counts, frames)), f"token counts {counts} vs {frames}")
    check(tokens.shape == (len(REQUEST_SECONDS), max(frames)), f"tokens {tuple(tokens.shape)}")
    say("requests", seconds=list(REQUEST_SECONDS), frames=frames, tokens=counts,
        launches=launches)
    return launches


def phase_slice():
    from efficientconformer_torch.config import encoder_output_frames, load_config
    from efficientconformer_torch.ops import rel_attention as RA

    enc_params = load_config(CONFIG)["encoder_params"]
    model = make_model("cuda", torch.float32)
    x, x_len = ragged_audio(REQUEST_SECONDS, "cuda", np.random.default_rng(SEED))
    with torch.inference_mode():
        logits_k, len_k = model(x, x_len)
        with mock.patch.object(RA, "relpos_attention", RA.reference_relpos_attention):
            logits_p, len_p = model(x, x_len)
    frames = [encoder_output_frames(enc_params, int(s * SAMPLE_RATE)) for s in REQUEST_SECONDS]
    check(len_k.tolist() == frames and len_p.tolist() == frames, f"lengths {len_k.tolist()}")
    check(bool(torch.isfinite(logits_k).all()), "non-finite logits")
    valid = torch.arange(logits_k.shape[1], device="cuda")[None, :] < len_k[:, None]
    err = (logits_k - logits_p).abs()[valid].max().item()
    agree = (logits_k.argmax(-1) == logits_p.argmax(-1))[valid].float().mean().item()
    check(err <= SLICE_TOL, f"kernel vs plain logits |diff| {err} > {SLICE_TOL}")
    check(agree >= SLICE_ARGMAX_AGREEMENT, f"argmax agreement {agree}")

    # the same model and batch on the CPU, where attention is the plain version
    cpu_model = make_model("cpu", torch.float32)
    with torch.inference_mode():
        logits_c, _ = cpu_model(x.cpu(), x_len.cpu())
    err_cpu = (logits_k.cpu() - logits_c).abs()[valid.cpu()].max().item()
    check(err_cpu <= SLICE_TOL, f"card vs CPU logits |diff| {err_cpu} > {SLICE_TOL}")
    say("slice", dtype="float32", max_abs_diff=f"{err:.3g}", argmax_agreement=f"{agree:.6f}",
        cpu_max_abs_diff=f"{err_cpu:.3g}", frames=frames)


def phase_rate(card_line: str):
    from efficientconformer_torch.models.model_ctc import greedy_decode

    model = make_model("cuda", torch.bfloat16)
    n = int(TIME_SECONDS * SAMPLE_RATE)
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy((rng.standard_normal((TIME_BATCH, n)) * 0.1).astype(np.float32)).cuda()
    x_len = torch.full((TIME_BATCH,), n, device="cuda")
    for _ in range(2):
        greedy_decode(model, x, x_len)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        tokens, counts = greedy_decode(model, x, x_len)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    check(bool((counts >= 0).all()), "negative token counts")
    say("rate", batch=TIME_BATCH, seconds=TIME_SECONDS, dtype="bfloat16",
        ms_per_batch=f"{dt * 1e3:.2f}", audio_s_per_s=f"{TIME_BATCH * TIME_SECONDS / dt:.1f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}", card=f"'{card_line}'")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the GPU")
    card_line = card()
    print(card_line, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)

    from efficientconformer_torch.config import load_config
    from efficientconformer_torch.ops import _kernels, rel_attention as RA

    t0 = time.perf_counter()
    report = _kernels.build(RA.KERNEL)
    _kernels.load(RA.KERNEL)
    say("build", kernel=RA.KERNEL, seconds=f"{time.perf_counter() - t0:.2f}")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    max_err, times = phase_kernel(load_config(CONFIG)["encoder_params"])
    launches = phase_requests()
    phase_slice()
    phase_rate(card_line)

    print(json.dumps({"kernels": [{
        "name": RA.KERNEL,
        "route": "cuda",
        "source": "efficientconformer_torch/csrc/rel_attention_fwd.cu",
        "replaces": "efficientconformer_tpu/ops/pallas_rel_attention.py:122",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": times["kernel"],
        "plain_ms": times["plain"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
