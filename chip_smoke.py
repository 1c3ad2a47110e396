#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--profile]

Drives the port's two paths at the full width of the flagship
configs/EfficientConformerCTCSmall.json with seeded random weights: batched
greedy CTC inference, and the CTC training step with the config's own
training_params. Holds every hand-written kernel on those paths to its plain
PyTorch version on the card. Phases, one line each; any failure exits
non-zero:

  1. device     CUDA present; card name and power limit; TF32 off
  2. build      both kernels, from the sources in this checkout, one nvcc
                each, started together; ptxas registers, shared memory, spills
  3. kernel     the forward kernel vs its plain version at the inference
                shapes (10 s of audio, batch 8, ragged key masks), fp32 and
                bf16; then kernel, plain and library timed at batch 128
  4. kernel-bwd the backward kernel vs its plain version at the training
                shapes (16 s, batch 8, ragged key masks), fp32 and bf16;
                then kernel, plain and library timed at batch 32, bf16
  5. requests   a ragged batch (2.5 s, 6 s, 10 s) decoded through
                greedy_decode in bf16; the forward kernel launches 15 times
  6. slice      full-width fp32 logits of that batch through the kernel vs
                through the plain version on the card, and vs the CPU
  7. rate       batch 128 x 10 s greedy decode in bf16: audio-s/s
  8. train-slice  one fp32 optimizer step (2 microbatches x 4 ragged
                utterances of 4-8 s, dropout 0, SpecAugment off) through the
                kernels vs through the plain versions on the card, and vs
                the CPU: loss, gradient norm, gradients, BatchNorm statistics;
                the backward kernel launches 15 times per microbatch
  9. train-learns  30 steps on one fixed batch (8 x 4 s, random labels),
                Constant lr 1e-3, dropout and SpecAugment on: the loss falls
 10. train-rate the config's own step: 2 microbatches x 32 x 16 s, bf16,
                dropout 0.1, SpecAugment, Adam + Transformer schedule:
                ms per step, audio-s/s, peak memory, launches per step

Then one JSON line with each kernel's launches, error, times and bound, and
last {"ok": true, "device": {...}}. With --profile it also prints a
torch.profiler device-time breakdown of one inference batch and of one
training step. There is no CPU path: without a GPU the script exits non-zero
and prints no result. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import itertools
import json
import math
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

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
TRAIN_SECONDS = 16.0         # the config's train_audio_max_length (256000 samples)
TRAIN_BATCH = 32             # the config's batch_size; accumulated_steps 2
GRAD_TOL = 1e-4              # fp32 backward kernel vs plain, relative to max(max|.|, 1):
                             # per-token gradients and the batch sums dW, ddelta, dbias
GRAD_BF16_TOL = 2e-2         # bf16: gradients rounded to bf16, Di from the bf16 O
TRAIN_LOSS_RTOL = 1e-4       # fp32 step, kernels vs plain versions, and card vs CPU
TRAIN_GRAD_TOL = 1e-3        # per parameter, relative to max(max|g|, 1): fp32 sums in
                             # another order through 15 blocks and 31 BatchNorms
TRAIN_STATS_TOL = 1e-4       # BatchNorm running statistics, relative to max(|x|, 1)
LEARN_STEPS = 30
LEARN_RATIO = 0.7            # the last loss of train-learns below 0.7 x the first
BF16_PEAK = 989e12           # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet, 700 W)
HBM_RATE = 3.35e12           # H100 SXM HBM3 bytes/s


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


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """(ms, what bounds it): the larger of FLOPs over the bf16 peak and bytes
    over the HBM rate."""
    t_ops, t_bytes = flops / BF16_PEAK, nbytes / HBM_RATE
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def attention_cost(b, n, dh, d, h, itemsize, backward):
    """Semantic FLOPs (the JAX kernels' cost estimates,
    ops/pallas_rel_attention.py:309 and :369-371, d_rel = D) and the bytes
    each input read once and each output written once: qu, k, v (+ o, dO)
    and the token outputs in the input type; LSE, delta, W, the tables and
    the key bias in fp32; dW and ddelta in fp32 for the backward."""
    tok = b * h * n * dh * itemsize
    consts = (h * dh + h * dh * d + 2 * n * d + b * n) * 4 + b * h * n * 4
    if backward:
        flops = 2 * b * h * n * (n * (6 * dh + 2 * d) + 3 * dh * d)
        return flops, 5 * tok + consts + 3 * tok + (h * dh * d + h * dh) * 4
    return 2 * b * h * n * (n * (2 * dh + d) + dh * d), 3 * tok + consts + tok


def augmented(args):
    """[qu | A] and [k | keytab] of the factorized attention (A formed with
    plain torch), the inputs of the library yardstick."""
    qu, k, v, delta, w, rowtab, keytab, bias, scale = args
    qv = qu.float() + delta[None, :, None, :]
    pq = torch.einsum("bhnd,hdk->bhnk", qv, w)
    hd = pq.shape[-1] // 2
    sin, cos = rowtab[:, :hd], rowtab[:, hd:]
    a = torch.cat([sin * pq[..., :hd] + cos * pq[..., hd:],
                   sin * pq[..., hd:] - cos * pq[..., :hd]], dim=-1)
    qa = torch.cat([qu, a.to(qu.dtype)], dim=-1)
    ka = torch.cat([k, keytab.to(k.dtype).expand(k.shape[0], k.shape[1], -1, -1)], dim=-1)
    return qa.contiguous(), ka.contiguous(), v.contiguous(), bias.to(qu.dtype)


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

    times = {"kernel": 0.0, "plain": 0.0, "kernel_fp32": 0.0, "plain_fp32": 0.0,
             "library": 0.0, "bound": 0.0}
    for name, n, dh, d, h, g in shapes:
        args = attention_inputs(TIME_BATCH, n, dh, d, h, g, "cuda", gen)
        args16 = [t.to(torch.bfloat16) for t in args[:3]] + list(args[3:])
        qa, ka, v, mask = augmented(args16)
        row = {}
        for label, fn, a in (("plain_fp32", RA.reference_relpos_attention, args),
                             ("kernel_fp32", RA.relpos_attention, args),
                             ("plain", RA.reference_relpos_attention, args16),
                             ("kernel", RA.relpos_attention, args16)):
            row[label] = cuda_ms(lambda: fn(*a))
        row["library"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            qa, ka, v, attn_mask=mask, scale=args[8]))
        row["bound"], bound_by = bound(*attention_cost(TIME_BATCH, n, dh, d, h, 2, False))
        for label, value in row.items():
            times[label] += value
        say("kernel-time", shape=name, B=TIME_BATCH, bound_by=bound_by,
            **{f"{k}_ms": f"{v:.4f}" for k, v in row.items()})
    times["bound_by"] = bound_by
    return max_err, times


def grad_errors(got, want):
    """max |diff| / max(max|want|, 1) of each of the six gradients."""
    names = ("dqu", "dk", "dv", "ddelta", "dw", "dbias")
    return {n: (g.float() - w.float()).abs().max().item() / max(w.abs().max().item(), 1.0)
            for n, g, w in zip(names, got, want)}


def phase_kernel_bwd(enc_params):
    """The backward kernel at the training stage shapes: fp32 against the
    plain backward on the same o, LSE and dO; bf16 against the plain
    backward on the same bf16-rounded inputs. Then timed at batch 32, bf16,
    beside the plain version and the library yardstick (forward and
    backward of scaled_dot_product_attention on the augmented features)."""
    from efficientconformer_torch.ops import rel_attention as RA

    gen = torch.Generator().manual_seed(SEED + 2)
    shapes = stage_shapes(enc_params, TRAIN_SECONDS)
    max_err = 0.0
    for name, n, dh, d, h, g in shapes:
        args = attention_inputs(CHECK_BATCH, n, dh, d, h, g, "cuda", gen)
        o, lse = RA.reference_relpos_attention(*args)
        do = torch.randn(o.shape, generator=gen).cuda()
        got = RA.relpos_attention_bwd(*args[:8], o, do, lse, args[8])
        want = RA.reference_relpos_attention_bwd(*args[:8], do, lse, args[8])
        torch.cuda.synchronize()
        err = grad_errors(got, want)
        check(max(err.values()) <= GRAD_TOL, f"{name} fp32 backward: {err} > {GRAD_TOL}")
        args16 = [t.to(torch.bfloat16) for t in args[:3]] + list(args[3:])
        o16, lse16 = RA.relpos_attention_fwd(*args16)
        got16 = RA.relpos_attention_bwd(*args16[:8], o16, do.bfloat16(), lse16, args[8])
        want16 = RA.reference_relpos_attention_bwd(*args16[:8], do.bfloat16(), lse16, args[8])
        err16 = grad_errors(got16, want16)
        check(got16[0].dtype == torch.bfloat16 and max(err16.values()) <= GRAD_BF16_TOL,
              f"{name} bf16 backward: {err16} > {GRAD_BF16_TOL}")
        max_err = max(max_err, *[(a.float() - b.float()).abs().max().item()
                                 for a, b in zip(got, want)])
        say("kernel-bwd", shape=name, B=CHECK_BATCH, N=n, dh=dh, D=d, H=h, G=g,
            fp32_rel_err=f"{max(err.values()):.3g}", bf16_rel_err=f"{max(err16.values()):.3g}")

    times = {"kernel": 0.0, "plain": 0.0, "library": 0.0, "bound": 0.0}
    for name, n, dh, d, h, g in shapes:
        args = attention_inputs(TRAIN_BATCH, n, dh, d, h, g, "cuda", gen)
        args16 = [t.to(torch.bfloat16) for t in args[:3]] + list(args[3:])
        o, lse = RA.relpos_attention_fwd(*args16)
        do = torch.randn(o.shape, generator=gen).to("cuda", torch.bfloat16)
        qa, ka, v, mask = augmented(args16)
        qa, ka, v = (t.detach().requires_grad_() for t in (qa, ka, v))
        do_lib = do.contiguous()

        def library():
            F.scaled_dot_product_attention(qa, ka, v, attn_mask=mask, scale=args[8]).backward(do_lib)

        row = {
            "plain": cuda_ms(lambda: RA.reference_relpos_attention_bwd(
                *args16[:8], do, lse, args[8])),
            "kernel": cuda_ms(lambda: RA.relpos_attention_bwd(
                *args16[:8], o, do, lse, args[8], need_dbias=False)),
            "library": cuda_ms(library),
        }
        row["bound"], bound_by = bound(*attention_cost(TRAIN_BATCH, n, dh, d, h, 2, True))
        for label, value in row.items():
            times[label] += value
        say("kernel-bwd-time", shape=name, B=TRAIN_BATCH, N=n, bound_by=bound_by,
            **{f"{k}_ms": f"{v:.4f}" for k, v in row.items()})
    times["bound_by"] = bound_by
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


# ---------------------------------------------------------------- training


def train_config(**training) -> dict:
    """The flagship's config, its training_params updated by ``training``."""
    from efficientconformer_torch.config import load_config

    cfg = load_config(CONFIG)
    cfg["training_params"].update(training)
    return cfg


def train_batch(accum, batch, seconds, label_len, device, rng):
    """Stacked microbatches (accum, batch, ...): random waveforms of the
    given lengths (zero past them) and random labels in [1, V), on
    ``device``; the lengths stay on the host, where the trainer reads them."""
    secs = np.broadcast_to(np.asarray(seconds, dtype=np.float64), (accum, batch))
    n = (secs * SAMPLE_RATE).astype(np.int64)
    t = int(n.max())
    audio = (rng.standard_normal((accum, batch, t)) * 0.1).astype(np.float32)
    audio[np.arange(t)[None, None, :] >= n[..., None]] = 0.0
    labels = rng.integers(1, 256, (accum, batch, max(label_len)))
    y_len = np.broadcast_to(np.asarray(label_len), (accum, batch)).copy()
    labels[np.arange(labels.shape[-1])[None, None, :] >= y_len[..., None]] = 0
    return {"audio": torch.from_numpy(audio).to(device), "audio_len": torch.from_numpy(n),
            "labels": torch.from_numpy(labels).to(device), "label_len": torch.from_numpy(y_len)}


def plain_relpos_bwd(qu, k, v, delta, w, rowtab, keytab, bias, o, do, lse, scale,
                     need_dbias=True):
    from efficientconformer_torch.ops import rel_attention as RA

    return RA.reference_relpos_attention_bwd(qu, k, v, delta, w, rowtab, keytab, bias, do,
                                             lse, scale)


@contextlib.contextmanager
def plain_attention():
    """Both directions of the rel-pos attention through their plain versions,
    on whatever device the tensors lie."""
    from efficientconformer_torch.ops import rel_attention as RA

    with mock.patch.object(RA, "relpos_attention_fwd", RA.reference_relpos_attention), \
            mock.patch.object(RA, "relpos_attention_bwd", plain_relpos_bwd):
        yield


def one_step(cfg, device, batch, plain=False):
    """(loss, grad norm, gradients, BatchNorm statistics) of one train step
    from the seeded weights; the gradients and statistics on the CPU."""
    from efficientconformer_torch.training.trainer import Trainer

    trainer = Trainer(cfg, device=device, seed=SEED)
    with plain_attention() if plain else contextlib.nullcontext():
        loss, grad_norm = trainer.train_step(batch)
    grads = {n: p.grad.float().cpu() for n, p in trainer.model.named_parameters()}
    stats = {n: b.cpu() for n, b in trainer.model.named_buffers() if "running" in n}
    return float(loss), float(grad_norm), grads, stats


def rel_diff(got: dict, want: dict) -> float:
    return max((got[k] - want[k]).abs().max().item() / max(want[k].abs().max().item(), 1.0)
               for k in want)


def phase_train_slice():
    from efficientconformer_torch.ops import rel_attention as RA

    cfg = train_config(mixed_precision=False)
    cfg["encoder_params"].update(Pdrop=0.0, spec_augment=False)
    seconds = [[4.0, 5.5, 7.0, 8.0], [8.0, 6.5, 4.5, 5.0]]
    batch = train_batch(2, 4, seconds, [12, 30, 0, 20], "cpu", np.random.default_rng(SEED))
    RA.relpos_attention.launches = RA.relpos_attention_bwd.launches = 0
    kernel = one_step(cfg, "cuda", batch)
    torch.cuda.synchronize()
    fwd, bwd = RA.relpos_attention.launches, RA.relpos_attention_bwd.launches
    n_att = cfg["encoder_params"]["num_blocks"] * 2      # one attention layer per block
    check(fwd == n_att and bwd == n_att, f"{fwd} forward / {bwd} backward launches, "
          f"expected {n_att} each for 2 microbatches")
    plain = one_step(cfg, "cuda", batch, plain=True)
    cpu = one_step(cfg, "cpu", batch)
    out = {}
    for label, other in (("plain", plain), ("cpu", cpu)):
        loss_err = abs(kernel[0] - other[0]) / abs(other[0])
        norm_err = abs(kernel[1] - other[1]) / abs(other[1])
        grad_err, stats_err = rel_diff(kernel[2], other[2]), rel_diff(kernel[3], other[3])
        check(loss_err <= TRAIN_LOSS_RTOL and norm_err <= TRAIN_LOSS_RTOL,
              f"kernel vs {label}: loss {kernel[0]} / {other[0]}, norm {kernel[1]} / {other[1]}")
        check(grad_err <= TRAIN_GRAD_TOL, f"kernel vs {label}: gradients {grad_err}")
        check(stats_err <= TRAIN_STATS_TOL, f"kernel vs {label}: BatchNorm statistics {stats_err}")
        out.update({f"{label}_loss_rel": f"{loss_err:.3g}", f"{label}_norm_rel": f"{norm_err:.3g}",
                    f"{label}_grad_rel": f"{grad_err:.3g}", f"{label}_stats_rel": f"{stats_err:.3g}"})
    say("train-slice", dtype="float32", loss=f"{kernel[0]:.6f}", grad_norm=f"{kernel[1]:.6f}",
        fwd_launches=fwd, bwd_launches=bwd, **out)


def phase_train_learns():
    from efficientconformer_torch.training.trainer import Trainer

    cfg = train_config(lr_schedule="Constant", lr_value=1e-3)
    trainer = Trainer(cfg, device="cuda", seed=SEED)
    batch = train_batch(1, 8, 4.0, [10, 14, 18, 12, 16, 8, 20, 11], "cuda",
                        np.random.default_rng(SEED + 3))
    losses = trainer.fit(itertools.repeat(batch), LEARN_STEPS)
    check(all(math.isfinite(x) for x in losses), f"non-finite losses {losses}")
    check(losses[-1] < LEARN_RATIO * losses[0], f"loss {losses[0]} -> {losses[-1]}")
    say("train-learns", steps=LEARN_STEPS, batch="8x4s", first_loss=f"{losses[0]:.4f}",
        last_loss=f"{losses[-1]:.4f}", min_loss=f"{min(losses):.4f}")


def rate_trainer():
    """The config's own training step (bf16, dropout 0.1, SpecAugment, Adam +
    Transformer schedule) and its batch: 2 microbatches of 32 x 16 s with
    labels of 80 tokens, on the card."""
    from efficientconformer_torch.training.trainer import Trainer

    cfg = train_config()
    tp = cfg["training_params"]
    trainer = Trainer(cfg, device="cuda", seed=SEED)
    batch = train_batch(tp["accumulated_steps"], tp["batch_size"],
                        tp["train_audio_max_length"] / SAMPLE_RATE, [80], "cuda",
                        np.random.default_rng(SEED + 4))
    return trainer, batch


def phase_train_rate(card_line: str):
    from efficientconformer_torch.ops import rel_attention as RA

    trainer, batch = rate_trainer()
    accum, b, t = batch["audio"].shape
    trainer.train_step(batch)
    torch.cuda.synchronize()
    RA.relpos_attention.launches = RA.relpos_attention_bwd.launches = 0
    trainer.train_step(batch)
    torch.cuda.synchronize()
    fwd, bwd = RA.relpos_attention.launches, RA.relpos_attention_bwd.launches
    n_att = trainer.config["encoder_params"]["num_blocks"] * accum
    check(fwd == n_att and bwd == n_att,
          f"{fwd} forward / {bwd} backward launches in one step, expected {n_att} each")
    torch.cuda.reset_peak_memory_stats()
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        loss, grad_norm = trainer.train_step(batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    check(math.isfinite(float(loss)) and math.isfinite(float(grad_norm)), f"loss {float(loss)}")
    audio_s = accum * b * t / SAMPLE_RATE
    say("train-rate", microbatches=accum, batch=b, seconds=t / SAMPLE_RATE, dtype="bfloat16",
        ms_per_step=f"{dt * 1e3:.2f}", audio_s_per_s=f"{audio_s / dt:.1f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        loss=f"{float(loss):.4f}", grad_norm=f"{float(grad_norm):.4f}",
        fwd_launches=fwd, bwd_launches=bwd, card=f"'{card_line}'")
    return bwd


def wall_ms(fn, iters: int = 3) -> float:
    """Host-clock ms per call of ``fn`` after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def profile(label: str, fn, wall: float, iters: int = 3) -> None:
    """Device time by kernel over ``iters`` calls of ``fn``, and the
    device's idle share: 1 - device time over ``wall``, the ms per call
    timed without any profiler (the profiler's own host cost, which lingers
    after a session, would inflate it). User-annotation ranges (the
    optimizer's) are left out, since the kernels inside them count already."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in rows) / 1e3 / iters
    say(f"profile-{label}", iters=iters, device_ms=f"{busy:.3f}", wall_ms=f"{wall:.3f}",
        idle_share=f"{1 - busy / wall:.3f}")
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:25]:
        ms = e.self_device_time_total / 1e3 / iters
        print(f"  {ms:9.3f} ms {100 * ms / busy:5.1f}% x{e.count // iters:<5d} {e.key[:110]}",
              flush=True)


def phase_profile():
    from efficientconformer_torch.models.model_ctc import greedy_decode

    model = make_model("cuda", torch.bfloat16)
    n = int(TIME_SECONDS * SAMPLE_RATE)
    x = torch.from_numpy((np.random.default_rng(SEED).standard_normal((TIME_BATCH, n)) * 0.1)
                         .astype(np.float32)).cuda()
    x_len = torch.full((TIME_BATCH,), n, device="cuda")
    trainer, batch = rate_trainer()
    paths = {"infer": lambda: greedy_decode(model, x, x_len),
             "train": lambda: trainer.train_step(batch)}
    walls = {label: wall_ms(fn) for label, fn in paths.items()}
    for label, fn in paths.items():
        profile(label, fn, walls[label])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also print a torch.profiler breakdown of both paths")
    opts = parser.parse_args()
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
    kernels = (RA.KERNEL, RA.KERNEL_BWD)
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
        reports = list(pool.map(_kernels.build, kernels))
    for name in kernels:
        _kernels.load(name)
    say("build", kernels=",".join(kernels), seconds=f"{time.perf_counter() - t0:.2f}")
    for line in "\n".join(reports).splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    # the kernels' shared memory is dynamic, so ptxas does not report it
    enc_params = load_config(CONFIG)["encoder_params"]
    fwd_lib, bwd_lib = _kernels.load(RA.KERNEL), _kernels.load(RA.KERNEL_BWD)
    RA._bind(fwd_lib)
    RA._bind_bwd(bwd_lib)
    for name, n, dh, d, h, g in stage_shapes(enc_params, TRAIN_SECONDS):
        say("build-smem", shape=name, dh=dh, rel_width=d,
            fwd_bytes=fwd_lib.ecf_relpos_attention_fwd_smem(dh, d),
            bwd_bytes=bwd_lib.ecf_relpos_attention_bwd_smem(dh, d), limit=RA._SMEM_LIMIT)

    max_err, times = phase_kernel(enc_params)
    max_err_bwd, times_bwd = phase_kernel_bwd(enc_params)
    launches = phase_requests()
    phase_slice()
    phase_rate(card_line)
    phase_train_slice()
    phase_train_learns()
    launches_bwd = phase_train_rate(card_line)
    if opts.profile:
        phase_profile()

    def entry(name, source, replaces, n, err, t):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n, "max_abs_err": err, "ms": t["kernel"], "plain_ms": t["plain"],
                "bound_ms": t["bound"], "bound_by": t["bound_by"], "library_ms": t["library"]}

    print(json.dumps({"kernels": [
        entry(RA.KERNEL, "efficientconformer_torch/csrc/rel_attention_fwd.cu",
              "efficientconformer_tpu/ops/pallas_rel_attention.py:122", launches, max_err,
              times),
        entry(RA.KERNEL_BWD, "efficientconformer_torch/csrc/rel_attention_bwd.cu",
              "efficientconformer_tpu/ops/pallas_rel_attention.py:139", launches_bwd,
              max_err_bwd, times_bwd),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
