#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--profile]

Drives the port's six paths at full width with seeded random weights: the
flagship configs/EfficientConformerCTCSmall.json (batched greedy CTC
inference, the CTC training step), configs/EfficientConformerTransducer
Small.json (batched greedy Transducer decoding, the Transducer training
step) and configs/LM-Transformer.json (scoring: eval loss and perplexity;
the LM training step), each with its config's own training_params. Holds
every hand-written kernel on those paths to its plain PyTorch version on
the card. Phases, one line each; any failure exits non-zero:

  1. device     CUDA present; card name and power limit; TF32 off
  2. build      all six kernels, from the sources in this checkout, one
                nvcc each, started together; ptxas registers, spills; the
                rel-pos kernels' shared memory on both routes at the stage
                shapes of all twelve ASR configs and which route takes each,
                the bias kernels' at the LM's widths on both routes (bf16:
                the tensor-core kernels, fp32: the FMA kernels)
  3. kernel     the rel-pos forward kernel vs its plain version at the CTC
                inference shapes (10 s of audio, batch 8, ragged key masks):
                fp32 on the FMA kernel, bf16 on the tensor-core kernel
                (route counters), each vs the fp32 plain version on the
                same inputs; then timed at b128 from CUDA graphs (device
                time) beside eager calls, the plain version, the bound and
                the library (SDPA's memory-efficient kernel on the
                augmented features)
  4. kernel-bwd the rel-pos backward kernels likewise at the CTC training
                shapes (16 s, batch 8); then timed at batch 32, bf16
  5. requests   a ragged batch (2.5 s, 6 s, 10 s) decoded through
                greedy_decode (CTC) in bf16; 15 forward launches, all on the
                tensor-core route (as in every bf16 phase below; every fp32
                slice is all on the FMA route)
  6. slice      full-width fp32 CTC logits through the kernel vs the plain
                version on the card, and vs the CPU
  7. rate       batch 128 x 10 s greedy CTC decode in bf16: audio-s/s
  8. train-slice  one fp32 CTC step (2 x 4 ragged utterances of 4-8 s,
                dropout 0, SpecAugment off), kernels vs plain versions on the
                card and vs the CPU; 15 backward launches per microbatch
  9. train-learns  30 CTC steps on one batch: the loss falls
 10. train-rate the CTC config's own step, 2 x 32 x 16 s, bf16: ms per step,
                audio-s/s, peak memory, launches per step
 11. t-kernel   both rel-pos kernels vs their plain versions at Transducer
                Small's 16 s stage shapes (head widths 75/35/50, rel widths
                100/140/200, batch 8, ragged key masks), fp32 and bf16, as
                in 3 and 4
 12. rnnt-kernel  both RNN-T lattice kernels vs their plain versions at the
                Transducer's training shape (B 16, T 201, U+1 91, ragged
                lengths with f_len = T, y_len = 0 and y_len = U; whether
                they are equal bit for bit there) and at U+1 = 150 (more
                than 128 threads a block); both timed at the training shape
                (device time from a CUDA graph, and per eager call) beside
                the plain versions and the bound
 13. t-requests the ragged batch decoded by the Transducer in bf16 with the
                label-looping greedy loop: 15 forward launches, tokens equal
                to the frame-synchronous loop's
 14. t-slice    full-width fp32 lattice logits through the kernels vs the
                plain versions on the card and vs the CPU; greedy tokens
                through the kernels equal to those through the plain versions
 15. t-rate     batch 16 x 10 s Transducer greedy decode in bf16: audio-s/s,
                tokens per utterance, loop iterations
 16. t-train-slice  one fp32 Transducer step (2 x 4 ragged utterances of
                4-8 s, labels of 10-30 tokens, dropout 0, SpecAugment and VN
                off), kernels vs plain versions on the card and vs the CPU
 17. t-train-learns  30 Transducer steps on one batch: the loss falls
 18. t-train-rate  the Transducer config's own step, 4 x 16 x 16 s with
                90-token labels, bf16: ms per step, audio-s/s, peak memory,
                launches per step (4 / 8 RNN-T: the backward's four calls
                launch two kernels each; 60 / 60 rel-pos); one more
                step with variational noise on
 19. lm-kernel  both bias-attention kernels vs their plain versions, fp32
                (the FMA kernels) and bf16 (the tensor-core kernels, by the
                route counters): at the LM's shape (B 8, H 12, N 101, dh 64)
                with its causal + padding + rel-pos bias and ragged lengths;
                a (B, 1, Nq, Nk) and a (1, H, Nq, Nk) bias, a key mask,
                dqk 90 / dv 70 at N 130, one fully masked row; then both
                timed at B 64, bf16, beside the plain versions, the bound and
                scaled_dot_product_attention, from CUDA graphs (device time)
                and per eager call (host time included)
 20. lm-slice   full-width fp32 LM-Transformer logits of 8 ragged sequences
                (10-100 tokens) through the kernel vs the plain version on
                the card, and vs the CPU; 12 forward launches, all on the
                FMA route
 21. lm-score-rate  eval loss and perplexity of 64 x 100 tokens (+ the
                blank) in bf16: ms per batch, tokens/s, 12 launches a batch,
                all on the tensor-core route
 22. lm-train-slice  one fp32 LM step (2 x 4 ragged sequences, dropout 0),
                kernels vs plain versions on the card and vs the CPU; every
                launch on the FMA route
 23. lm-train-learns  30 LM steps on one batch: the loss falls
 24. lm-train-rate  the LM config's own step, 5 x 64 x 100 tokens, bf16,
                dropout 0.1: ms per step, tokens/s, peak memory, launches per
                step (60 / 60, all on the tensor-core route), model FLOPs
                over the bf16 peak

Then one JSON line with each kernel's launches, error, times and bound (the
rel-pos entries also with their bf16 error, tensor-core launches and eager
per-call ms), and last {"ok": true, "device": {...}}. With --profile it also prints a
torch.profiler device-time breakdown of one batch or step of each path.
There is no CPU path: without a GPU the script exits non-zero and prints no
result. Imports nothing of JAX.
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
ASR_CONFIGS = [f"configs/{arch}{head}{size}.json" for arch in ("Conformer", "EfficientConformer")
               for head in ("CTC", "Transducer") for size in ("Small", "Medium", "Large")]
T_CONFIG = "configs/EfficientConformerTransducerSmall.json"
LM_CONFIG = "configs/LM-Transformer.json"
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
# The rel-pos tensor-core kernels also round W, delta, the tables, qv, A, P,
# dS and dpq to bf16 where the TPU kernel does; they are held within the two
# bf16 bounds above to the fp32 plain version on the same bf16 qu, k and v.
TRAIN_LOSS_RTOL = 1e-4       # fp32 step, kernels vs plain versions, and card vs CPU
TRAIN_GRAD_TOL = 1e-3        # per parameter, relative to max(max|g|, 1): fp32 sums in
                             # another order through 15 blocks and 31 BatchNorms
TRAIN_STATS_TOL = 1e-4       # BatchNorm running statistics, relative to max(|x|, 1)
LEARN_STEPS = 30
LEARN_RATIO = 0.7            # the last loss of train-learns below 0.7 x the first
MAX_CONSEC = 5               # max_consec_dec_steps of the greedy Transducer loops
T_RATE_BATCH = 16
RNNT_LOSS_RTOL = 1e-5        # RNN-T kernels vs plain: the same fp32 recursion, same order
RNNT_GRAD_TOL = 1e-5         # their gradients are probabilities, at most 1
RNNT_WIDE = (4, 60, 150)     # (B, T, U+1) with U+1 > 128: more than 128 threads a block
LM_CHECK_BATCH = 8
LM_TIME_BATCH = 64           # the LM config's batch_size
LM_SLICE_LENGTHS = (10, 100)  # ragged sequences of 10..100 tokens
BF16_PEAK = 989e12           # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet, 700 W)
FP32_PEAK = 67e12            # H100 SXM fp32 FLOP/s outside the tensor cores
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


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device ms per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed and timed with CUDA events. Unlike cuda_ms it leaves out
    the host's time per call (Python, allocations, the launch: 40-120 us for
    the bias-attention wrappers), which back-to-back eager calls expose once
    a kernel takes about as long."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def bound(flops: float, nbytes: float, peak: float = BF16_PEAK) -> tuple[float, str]:
    """(ms, what bounds it): the larger of FLOPs over the peak of their type
    (bf16 tensor cores unless given) and bytes over the HBM rate."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_RATE
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
    """[qu | A], [k | keytab] (A formed with plain torch) and v, each
    zero-padded to a multiple of 8 columns, and the key mask in bf16: the
    inputs of the library yardstick. Zero columns change neither the scores
    nor the other columns of O; without them (widths 210, 300, 90, 42, 60)
    scaled_dot_product_attention falls back to its fp32 math path."""
    qu, k, v, delta, w, rowtab, keytab, bias, scale = args
    qv = qu.float() + delta[None, :, None, :]
    pq = torch.einsum("bhnd,hdk->bhnk", qv, w)
    hd = pq.shape[-1] // 2
    sin, cos = rowtab[:, :hd], rowtab[:, hd:]
    a = torch.cat([sin * pq[..., :hd] + cos * pq[..., hd:],
                   sin * pq[..., hd:] - cos * pq[..., :hd]], dim=-1)
    qa = torch.cat([qu, a.to(qu.dtype)], dim=-1)
    ka = torch.cat([k, keytab.to(k.dtype).expand(k.shape[0], k.shape[1], -1, -1)], dim=-1)
    return pad8(qa), pad8(ka), pad8(v), bias.to(qu.dtype)


def pad8(t):
    return F.pad(t, (0, -t.shape[-1] % 8)).contiguous()


def sdpa_yardstick(qa, ka, v, mask, scale, do=None):
    """(fn, backend): scaled_dot_product_attention on the augmented features
    (forward, or forward and backward against ``do``) restricted to its
    memory-efficient kernel, the one that takes these widths and a float
    mask; where that refuses them, PyTorch's own choice ("default")."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def call():
        o = F.scaled_dot_product_attention(qa, ka, v, attn_mask=mask, scale=scale)
        return o if do is None else torch.autograd.grad(o, (qa, ka, v), do)

    def efficient():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return call()

    try:
        efficient()
        torch.cuda.synchronize()
    except RuntimeError:
        return call, "default"
    return efficient, "efficient"


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

    return perturb_norms_(build_model(CONFIG, device, dtype, torch.Generator().manual_seed(SEED)))


def make_transducer(device, dtype):
    """Transducer Small at full width, as make_model."""
    from efficientconformer_torch.models.transducer import build_model

    return perturb_norms_(build_model(T_CONFIG, device, dtype,
                                      torch.Generator().manual_seed(SEED)))


def perturb_norms_(model):
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


def rel_counts():
    from efficientconformer_torch.ops import rel_attention as RA

    return (RA.relpos_attention.launches, RA.relpos_attention.tc_launches,
            RA.relpos_attention_bwd.launches, RA.relpos_attention_bwd.tc_launches)


def reset_rel_counts():
    from efficientconformer_torch.ops import rel_attention as RA

    RA.relpos_attention.launches = RA.relpos_attention.tc_launches = 0
    RA.relpos_attention_bwd.launches = RA.relpos_attention_bwd.tc_launches = 0


def check_forward(phase, enc_params, seconds, gen):
    """The rel-pos forward kernel vs its plain version at the stage shapes
    of ``seconds`` of audio: fp32 (the FMA kernel) and bf16 (the
    tensor-core kernel, by the route counters), each vs the fp32 plain
    version on the same inputs. The largest fp32 and bf16 errors."""
    from efficientconformer_torch.ops import rel_attention as RA

    max_err = max_err16 = 0.0
    for name, n, dh, d, h, g in stage_shapes(enc_params, seconds):
        args = attention_inputs(CHECK_BATCH, n, dh, d, h, g, "cuda", gen)
        reset_rel_counts()
        o_k, lse_k = RA.relpos_attention(*args)
        o_p, lse_p = RA.reference_relpos_attention(*args)
        torch.cuda.synchronize()
        check(rel_counts()[:2] == (1, 0), f"{name} fp32: route counts {rel_counts()}")
        err_o = (o_k - o_p).abs().max().item()
        err_lse = (lse_k - lse_p).abs().max().item()
        check(err_o <= KERNEL_FP32_TOL and err_lse <= KERNEL_FP32_TOL,
              f"{name} fp32: |O| {err_o} |LSE| {err_lse} > {KERNEL_FP32_TOL}")
        args16 = [t.to(torch.bfloat16) for t in args[:3]] + list(args[3:])
        o_b, _ = RA.relpos_attention(*args16)
        o_bp, _ = RA.reference_relpos_attention(*[t.float() for t in args16[:3]], *args[3:])
        torch.cuda.synchronize()
        check(rel_counts()[:2] == (2, 1), f"{name} bf16: route counts {rel_counts()}, "
              "expected the tensor-core kernel")
        err_b = (o_b.float() - o_bp).abs().max().item()
        check(o_b.dtype == torch.bfloat16 and err_b <= KERNEL_BF16_TOL,
              f"{name} bf16: |O| {err_b} > {KERNEL_BF16_TOL}")
        max_err, max_err16 = max(max_err, err_o, err_lse), max(max_err16, err_b)
        say(phase, shape=name, B=CHECK_BATCH, N=n, dh=dh, D=d, H=h, G=g,
            fp32_err_o=f"{err_o:.3g}", fp32_err_lse=f"{err_lse:.3g}", bf16_err_o=f"{err_b:.3g}",
            route="fma/tensor-core")
    return max_err, max_err16


def phase_kernel(enc_params):
    """The forward checked at the inference stage shapes, then timed at
    b128 in bf16: the kernel, its fp32 route and the library from CUDA
    graphs (device time; *_ms), the kernel also per eager call (host time
    included; kernel_call_ms), the plain version per eager call, and the
    bound. The library's backend stands in each line."""
    from efficientconformer_torch.ops import rel_attention as RA

    gen = torch.Generator().manual_seed(SEED)
    shapes = stage_shapes(enc_params, TIME_SECONDS)
    max_err, max_err16 = check_forward("kernel", enc_params, TIME_SECONDS, gen)
    times = {"kernel": 0.0, "kernel_call": 0.0, "plain": 0.0, "kernel_fp32": 0.0,
             "library": 0.0, "bound": 0.0}
    for name, n, dh, d, h, g in shapes:
        args = attention_inputs(TIME_BATCH, n, dh, d, h, g, "cuda", gen)
        args16 = [t.to(torch.bfloat16) for t in args[:3]] + list(args[3:])
        library, backend = sdpa_yardstick(*augmented(args16), args[8])
        row = {"kernel": graph_ms(lambda: RA.relpos_attention_fwd(*args16)),
               "kernel_call": cuda_ms(lambda: RA.relpos_attention_fwd(*args16)),
               "plain": cuda_ms(lambda: RA.reference_relpos_attention(*args16)),
               "kernel_fp32": graph_ms(lambda: RA.relpos_attention_fwd(*args)),
               "library": graph_ms(library)}
        row["bound"], bound_by = bound(*attention_cost(TIME_BATCH, n, dh, d, h, 2, False))
        for label, value in row.items():
            times[label] += value
        say("kernel-time", shape=name, B=TIME_BATCH, bound_by=bound_by,
            library=f"sdpa_{backend}", **{f"{k}_ms": f"{v:.4f}" for k, v in row.items()})
    times["bound_by"] = bound_by
    return max_err, max_err16, times


def grad_errors(got, want):
    """max |diff| / max(max|want|, 1) of each of the six gradients."""
    names = ("dqu", "dk", "dv", "ddelta", "dw", "dbias")
    return {n: (g.float() - w.float()).abs().max().item() / max(w.abs().max().item(), 1.0)
            for n, g, w in zip(names, got, want)}


def check_backward(phase, enc_params, seconds, gen):
    """The rel-pos backward kernels at the stage shapes of ``seconds`` of
    audio: fp32 (the FMA kernels) against the plain backward on the same o,
    LSE and dO; bf16 (the tensor-core kernels, by the route counters)
    against the plain backward on the same bf16 inputs, twice, the second
    bitwise equal to the first. The largest fp32 error
    and the largest bf16 relative error."""
    from efficientconformer_torch.ops import rel_attention as RA

    max_err = max_err16 = 0.0
    for name, n, dh, d, h, g in stage_shapes(enc_params, seconds):
        args = attention_inputs(CHECK_BATCH, n, dh, d, h, g, "cuda", gen)
        o, lse = RA.reference_relpos_attention(*args)
        do = torch.randn(o.shape, generator=gen).cuda()
        reset_rel_counts()
        got = RA.relpos_attention_bwd(*args[:8], o, do, lse, args[8])
        want = RA.reference_relpos_attention_bwd(*args[:8], do, lse, args[8])
        torch.cuda.synchronize()
        err = grad_errors(got, want)
        check(max(err.values()) <= GRAD_TOL, f"{name} fp32 backward: {err} > {GRAD_TOL}")
        args16 = [t.to(torch.bfloat16) for t in args[:3]] + list(args[3:])
        o16, lse16 = RA.relpos_attention_fwd(*args16)
        got16 = RA.relpos_attention_bwd(*args16[:8], o16, do.bfloat16(), lse16, args[8])
        again = RA.relpos_attention_bwd(*args16[:8], o16, do.bfloat16(), lse16, args[8])
        want16 = RA.reference_relpos_attention_bwd(*args16[:8], do.bfloat16(), lse16, args[8])
        torch.cuda.synchronize()
        check(rel_counts()[2:] == (3, 2), f"{name}: backward route counts {rel_counts()[2:]}, "
              "expected fp32 on the FMA kernels and bf16 on the tensor cores")
        check(all(torch.equal(a, b) for a, b in zip(got16, again)),
              f"{name} bf16 backward is not bitwise repeatable")
        err16 = grad_errors(got16, want16)
        check(got16[0].dtype == torch.bfloat16 and max(err16.values()) <= GRAD_BF16_TOL,
              f"{name} bf16 backward: {err16} > {GRAD_BF16_TOL}")
        max_err = max(max_err, *[(a.float() - b.float()).abs().max().item()
                                 for a, b in zip(got, want)])
        max_err16 = max(max_err16, *err16.values())
        say(phase, shape=name, B=CHECK_BATCH, N=n, dh=dh, D=d, H=h, G=g,
            fp32_rel_err=f"{max(err.values()):.3g}", bf16_rel_err=f"{max(err16.values()):.3g}",
            bf16_repeatable="bitwise")
    return max_err, max_err16


def phase_kernel_bwd(enc_params):
    """The backward kernels checked at the training stage shapes, then timed
    at batch 32, bf16, as phase_kernel times the forward; the library
    yardstick is the forward and backward of scaled_dot_product_attention
    on the augmented features."""
    from efficientconformer_torch.ops import rel_attention as RA

    gen = torch.Generator().manual_seed(SEED + 2)
    shapes = stage_shapes(enc_params, TRAIN_SECONDS)
    max_err, max_err16 = check_backward("kernel-bwd", enc_params, TRAIN_SECONDS, gen)
    times = {"kernel": 0.0, "kernel_call": 0.0, "plain": 0.0, "kernel_fp32": 0.0,
             "library": 0.0, "bound": 0.0}
    for name, n, dh, d, h, g in shapes:
        args = attention_inputs(TRAIN_BATCH, n, dh, d, h, g, "cuda", gen)
        args16 = [t.to(torch.bfloat16) for t in args[:3]] + list(args[3:])
        o, lse = RA.relpos_attention_fwd(*args16)
        o32, lse32 = RA.relpos_attention_fwd(*args)
        do = torch.randn(o.shape, generator=gen).to("cuda", torch.bfloat16)
        do32 = do.float()
        qa, ka, v, mask = augmented(args16)
        qa, ka, v = (t.detach().requires_grad_() for t in (qa, ka, v))
        library, backend = sdpa_yardstick(qa, ka, v, mask, args[8], pad8(do))

        def kernel():
            return RA.relpos_attention_bwd(*args16[:8], o, do, lse, args[8], need_dbias=False)

        row = {"kernel": graph_ms(kernel), "kernel_call": cuda_ms(kernel),
               "plain": cuda_ms(lambda: RA.reference_relpos_attention_bwd(
                   *args16[:8], do, lse, args[8])),
               "kernel_fp32": graph_ms(lambda: RA.relpos_attention_bwd(
                   *args[:8], o32, do32, lse32, args[8], need_dbias=False)),
               "library": graph_ms(library)}
        row["bound"], bound_by = bound(*attention_cost(TRAIN_BATCH, n, dh, d, h, 2, True))
        for label, value in row.items():
            times[label] += value
        say("kernel-bwd-time", shape=name, B=TRAIN_BATCH, N=n, bound_by=bound_by,
            library=f"sdpa_{backend}", **{f"{k}_ms": f"{v:.4f}" for k, v in row.items()})
    times["bound_by"] = bound_by
    return max_err, max_err16, times


def phase_requests():
    from efficientconformer_torch.config import encoder_output_frames, load_config
    from efficientconformer_torch.models.model_ctc import greedy_decode

    enc_params = load_config(CONFIG)["encoder_params"]
    model = make_model("cuda", torch.bfloat16)
    x, x_len = ragged_audio(REQUEST_SECONDS, "cuda", np.random.default_rng(SEED))
    reset_rel_counts()
    tokens, counts = greedy_decode(model, x, x_len)
    torch.cuda.synchronize()
    launches, tc = rel_counts()[:2]
    n_att = len(model.encoder.blocks)
    check(launches == n_att and tc == n_att, f"{launches} kernel launches for one forward, "
          f"{tc} on the tensor cores, expected {n_att} each")
    frames = [encoder_output_frames(enc_params, int(s * SAMPLE_RATE)) for s in REQUEST_SECONDS]
    counts = counts.tolist()
    check(all(0 <= c <= f for c, f in zip(counts, frames)), f"token counts {counts} vs {frames}")
    check(tokens.shape == (len(REQUEST_SECONDS), max(frames)), f"tokens {tuple(tokens.shape)}")
    say("requests", seconds=list(REQUEST_SECONDS), frames=frames, tokens=counts,
        launches=launches, tc_launches=tc)
    return launches, tc


def phase_slice():
    from efficientconformer_torch.config import encoder_output_frames, load_config
    from efficientconformer_torch.ops import rel_attention as RA

    enc_params = load_config(CONFIG)["encoder_params"]
    model = make_model("cuda", torch.float32)
    x, x_len = ragged_audio(REQUEST_SECONDS, "cuda", np.random.default_rng(SEED))
    reset_rel_counts()
    with torch.inference_mode():
        logits_k, len_k = model(x, x_len)
        torch.cuda.synchronize()
        counts = rel_counts()[:2]
        check(counts == (len(model.encoder.blocks), 0), f"fp32 launches {counts}, expected "
              "every one on the FMA route")
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
        cpu_max_abs_diff=f"{err_cpu:.3g}", frames=frames, launches=counts[0], route="fma")


def phase_rate(card_line: str):
    from efficientconformer_torch.models.model_ctc import greedy_decode

    model = make_model("cuda", torch.bfloat16)
    n = int(TIME_SECONDS * SAMPLE_RATE)
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy((rng.standard_normal((TIME_BATCH, n)) * 0.1).astype(np.float32)).cuda()
    x_len = torch.full((TIME_BATCH,), n, device="cuda")
    greedy_decode(model, x, x_len)
    reset_rel_counts()
    greedy_decode(model, x, x_len)
    torch.cuda.synchronize()
    launches, tc = rel_counts()[:2]
    check(launches == tc == len(model.encoder.blocks),
          f"rel-pos launches {launches}, {tc} on the tensor cores, for one batch")
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
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}", launches=launches,
        tc_launches=tc, card=f"'{card_line}'")


# ---------------------------------------------------------------- training


def train_config(path=CONFIG, **training) -> dict:
    """The config at ``path``, its training_params updated by ``training``."""
    from efficientconformer_torch.config import load_config

    cfg = load_config(path)
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
    labels = rng.integers(1, 256, (accum, batch, int(np.max(label_len))))
    y_len = np.broadcast_to(np.asarray(label_len), (accum, batch)).copy()
    labels[np.arange(labels.shape[-1])[None, None, :] >= y_len[..., None]] = 0
    return {"audio": torch.from_numpy(audio).to(device), "audio_len": torch.from_numpy(n),
            "labels": torch.from_numpy(labels).to(device), "label_len": torch.from_numpy(y_len)}


def plain_relpos_bwd(qu, k, v, delta, w, rowtab, keytab, bias, o, do, lse, scale,
                     need_dbias=True):
    from efficientconformer_torch.ops import rel_attention as RA

    return RA.reference_relpos_attention_bwd(qu, k, v, delta, w, rowtab, keytab, bias, do,
                                             lse, scale)


def plain_rnnt_alphas(blank_lp, emit_lp, f_len, y_len):
    from efficientconformer_torch.ops import rnnt_loss as RL

    alphas = RL.reference_rnnt_alphas(blank_lp, emit_lp)
    return alphas, RL.loss_from_alphas(alphas, blank_lp, f_len, y_len)


def plain_bias_bwd(q, k, v, bias, o, do, lse, scale, need_dbias=True):
    from efficientconformer_torch.ops import bias_attention as BA

    return BA.reference_bias_attention_bwd(q, k, v, bias, do, scale)


@contextlib.contextmanager
def plain_kernels():
    """Both directions of the rel-pos attention, of the RNN-T lattice and of
    the bias attention through their plain versions, on whatever device the
    tensors lie."""
    from efficientconformer_torch.ops import bias_attention as BA
    from efficientconformer_torch.ops import rel_attention as RA
    from efficientconformer_torch.ops import rnnt_loss as RL

    with mock.patch.object(RA, "relpos_attention_fwd", RA.reference_relpos_attention), \
            mock.patch.object(RA, "relpos_attention_bwd", plain_relpos_bwd), \
            mock.patch.object(RL, "rnnt_alphas", plain_rnnt_alphas), \
            mock.patch.object(RL, "rnnt_grads", RL.reference_rnnt_grads), \
            mock.patch.object(BA, "bias_attention_fwd", BA.reference_bias_attention), \
            mock.patch.object(BA, "bias_attention_bwd", plain_bias_bwd):
        yield


def one_step(cfg, device, batch, plain=False):
    """(loss, grad norm, gradients, BatchNorm statistics) of one train step
    from the seeded weights; the gradients and statistics on the CPU."""
    from efficientconformer_torch.training.trainer import Trainer

    trainer = Trainer(cfg, device=device, seed=SEED)
    with plain_kernels() if plain else contextlib.nullcontext():
        loss, grad_norm = trainer.train_step(batch)
    grads = {n: p.grad.float().cpu() for n, p in trainer.model.named_parameters()}
    stats = {n: b.cpu() for n, b in trainer.model.named_buffers() if "running" in n}
    return float(loss), float(grad_norm), grads, stats


def rel_diff(got: dict, want: dict) -> float:
    return max(((got[k] - want[k]).abs().max().item() / max(want[k].abs().max().item(), 1.0)
                for k in want), default=0.0)


def compare_steps(kernel, cfg, batch) -> dict:
    """Hold one step through the kernels (``kernel``, from one_step) to the
    same step through the plain versions on the card and on the CPU: loss,
    gradient norm, gradients, BatchNorm statistics. The errors, by name."""
    out = {}
    for label, other in (("plain", one_step(cfg, "cuda", batch, plain=True)),
                         ("cpu", one_step(cfg, "cpu", batch))):
        loss_err = abs(kernel[0] - other[0]) / abs(other[0])
        norm_err = abs(kernel[1] - other[1]) / abs(other[1])
        grad_err, stats_err = rel_diff(kernel[2], other[2]), rel_diff(kernel[3], other[3])
        check(loss_err <= TRAIN_LOSS_RTOL and norm_err <= TRAIN_LOSS_RTOL,
              f"kernel vs {label}: loss {kernel[0]} / {other[0]}, norm {kernel[1]} / {other[1]}")
        check(grad_err <= TRAIN_GRAD_TOL, f"kernel vs {label}: gradients {grad_err}")
        check(stats_err <= TRAIN_STATS_TOL, f"kernel vs {label}: BatchNorm statistics {stats_err}")
        out.update({f"{label}_loss_rel": f"{loss_err:.3g}", f"{label}_norm_rel": f"{norm_err:.3g}",
                    f"{label}_grad_rel": f"{grad_err:.3g}", f"{label}_stats_rel": f"{stats_err:.3g}"})
    return out


def phase_train_slice():
    cfg = train_config(mixed_precision=False)
    cfg["encoder_params"].update(Pdrop=0.0, spec_augment=False)
    seconds = [[4.0, 5.5, 7.0, 8.0], [8.0, 6.5, 4.5, 5.0]]
    batch = train_batch(2, 4, seconds, [12, 30, 0, 20], "cpu", np.random.default_rng(SEED))
    reset_rel_counts()
    kernel = one_step(cfg, "cuda", batch)
    torch.cuda.synchronize()
    fwd, fwd_tc, bwd, bwd_tc = rel_counts()
    n_att = cfg["encoder_params"]["num_blocks"] * 2      # one attention layer per block
    check(fwd == n_att and bwd == n_att, f"{fwd} forward / {bwd} backward launches, "
          f"expected {n_att} each for 2 microbatches")
    check(fwd_tc == bwd_tc == 0, f"fp32 step: tensor-core launches {fwd_tc} / {bwd_tc}")
    out = compare_steps(kernel, cfg, batch)
    say("train-slice", dtype="float32", loss=f"{kernel[0]:.6f}", grad_norm=f"{kernel[1]:.6f}",
        fwd_launches=fwd, bwd_launches=bwd, route="fma", **out)


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
    trainer, batch = rate_trainer()
    accum, b, t = batch["audio"].shape
    trainer.train_step(batch)
    torch.cuda.synchronize()
    reset_rel_counts()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    fwd, fwd_tc, bwd, bwd_tc = rel_counts()
    n_att = trainer.config["encoder_params"]["num_blocks"] * accum
    check(fwd == n_att and bwd == n_att,
          f"{fwd} forward / {bwd} backward launches in one step, expected {n_att} each")
    check(fwd_tc == fwd and bwd_tc == bwd, f"tensor-core launches {fwd_tc} / {bwd_tc}, "
          "expected every launch")
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
        fwd_launches=fwd, bwd_launches=bwd, tc_launches=(fwd_tc, bwd_tc), card=f"'{card_line}'")
    return bwd, bwd_tc


# ---------------------------------------------------------------- Transducer


def phase_t_kernel(t_enc):
    """Both rel-pos kernels at Transducer Small's 16 s stage shapes."""
    gen = torch.Generator().manual_seed(SEED + 5)
    return (check_forward("t-kernel", t_enc, TRAIN_SECONDS, gen),
            check_backward("t-kernel-bwd", t_enc, TRAIN_SECONDS, gen))


def rnnt_inputs(b, t, u1, seed):
    """Gathered blank / emit log-probs (B, T, U+1) of about the size a
    1000-token vocabulary gives, and ragged lengths on the card: the first
    utterance has f_len = T and y_len = U, the last y_len = 0."""
    gen = torch.Generator().manual_seed(seed)
    lp = (torch.randn(b, t, u1, 3, generator=gen) * 2).log_softmax(-1) - math.log(333.0)
    f_len = torch.linspace(t, max(t // 3, 1), b).round().int()
    y_len = torch.linspace(0, u1 - 1, b).round().int().flip(0)
    y_len[-1] = 0
    return [x.cuda() for x in (lp[..., 0].contiguous(), lp[..., 1].contiguous(), f_len, y_len)]


def rnnt_cost(blank, f_len, y_len, backward):
    """(operations, bytes) the lattice pass must do at these lengths: the
    forward covers the whole (T, U+1) lattice (reads blank and emit, writes
    the alphas and the loss), about 10 fp32 operations a cell; the backward
    reads alpha, blank and emit inside each utterance's lattice and writes
    both gradients everywhere, about 20 operations an inside cell."""
    b, t, u1 = blank.shape
    cells = b * t * u1
    if not backward:
        return 10 * cells, 4 * (3 * cells + b) + 8 * b
    inside = int((f_len.long() * (y_len.long() + 1)).sum())
    return 20 * inside, 4 * (3 * inside + 2 * cells + b) + 8 * b


def phase_rnnt_kernel(t_cfg):
    """Both RNN-T kernels vs their plain versions on the same inputs (the
    backward on the kernel's alphas and loss), at the training shape and at
    U+1 > 128; then both timed at the training shape."""
    from efficientconformer_torch.config import encoder_output_frames
    from efficientconformer_torch.ops import rnnt_loss as RL

    tp = t_cfg["training_params"]
    shape = (tp["batch_size"], encoder_output_frames(t_cfg["encoder_params"],
                                                     tp["train_audio_max_length"]),
             tp["train_label_max_length"] + 1)
    err_f = err_b = 0.0
    for i, (b, t, u1) in enumerate((shape, RNNT_WIDE)):
        blank, emit, f_len, y_len = rnnt_inputs(b, t, u1, SEED + 6 + i)
        alphas, loss = RL.rnnt_alphas(blank, emit, f_len, y_len)
        want_a, want_l = plain_rnnt_alphas(blank, emit, f_len, y_len)
        grads = RL.rnnt_grads(blank, emit, alphas, f_len, y_len, -loss)
        want_g = RL.reference_rnnt_grads(blank, emit, alphas, f_len, y_len, -loss)
        torch.cuda.synchronize()
        alpha_err = (alphas - want_a).abs().max().item()
        alpha_rel = alpha_err / max(want_a.abs().max().item(), 1.0)
        loss_rel = ((loss - want_l).abs() / want_l.abs()).max().item()
        grad_err = max((g - w).abs().max().item() for g, w in zip(grads, want_g))
        check(loss_rel <= RNNT_LOSS_RTOL and alpha_rel <= RNNT_LOSS_RTOL,
              f"RNN-T forward {b}x{t}x{u1}: loss {loss_rel}, alphas {alpha_rel} > {RNNT_LOSS_RTOL}")
        check(grad_err <= RNNT_GRAD_TOL, f"RNN-T backward {b}x{t}x{u1}: {grad_err}")
        inside = ((torch.arange(t, device="cuda")[None, :, None] < f_len[:, None, None].long())
                  & (torch.arange(u1, device="cuda")[None, None, :] <= y_len[:, None, None].long()))
        check(all(bool((g[~inside] == 0).all()) for g in grads), "non-zero outside a lattice")
        err_f = max(err_f, alpha_err, (loss - want_l).abs().max().item())
        err_b = max(err_b, grad_err)
        bitwise = (torch.equal(alphas, want_a) and torch.equal(loss, want_l)
                   and all(torch.equal(g, w) for g, w in zip(grads, want_g)))
        say("rnnt-kernel", B=b, T=t, U1=u1, f_len=f"{int(f_len.min())}..{int(f_len.max())}",
            y_len=f"{int(y_len.min())}..{int(y_len.max())}", loss_rel_err=f"{loss_rel:.3g}",
            alpha_abs_err=f"{alpha_err:.3g}", alpha_rel_err=f"{alpha_rel:.3g}",
            grad_abs_err=f"{grad_err:.3g}", bitwise_equal=bitwise)

    blank, emit, f_len, y_len = rnnt_inputs(*shape, SEED + 6)
    alphas, loss = RL.rnnt_alphas(blank, emit, f_len, y_len)
    n_diags = (shape[1] + shape[2] - 1, int((f_len + y_len).max()))
    calls = ((lambda: RL.rnnt_alphas(blank, emit, f_len, y_len),
              lambda: plain_rnnt_alphas(blank, emit, f_len, y_len)),
             (lambda: RL.rnnt_grads(blank, emit, alphas, f_len, y_len, -loss),
              lambda: RL.reference_rnnt_grads(blank, emit, alphas, f_len, y_len, -loss)))
    times = []
    for backward, (kernel, plain) in enumerate(calls):
        row = {"kernel": graph_ms(kernel), "plain": cuda_ms(plain, iters=3, warmup=1),
               "library": None}
        row["bound"], row["bound_by"] = bound(*rnnt_cost(blank, f_len, y_len, backward),
                                              peak=FP32_PEAK)
        threads, ring, smem = RL.launch_geometry(shape[2])
        say("rnnt-kernel-time", direction="backward" if backward else "forward",
            B=shape[0], T=shape[1], U1=shape[2], threads=threads, ring=ring, smem_bytes=smem,
            bound_by=row["bound_by"], kernel_ms=f"{row['kernel']:.4f}",
            eager_ms=f"{cuda_ms(kernel):.4f}", plain_ms=f"{row['plain']:.4f}",
            bound_ms=f"{row['bound']:.6f}", library_ms="none (no torchaudio)",
            n_diag=n_diags[backward],
            us_per_diagonal=f"{1e3 * row['kernel'] / n_diags[backward]:.3f}")
        times.append(row)
    return err_f, times[0], err_b, times[1]


def t_batch_labels(n, u_max, seed):
    """Random labels in [1, 1000) for n utterances, u_max and shorter."""
    rng = np.random.default_rng(seed)
    y_len = np.linspace(u_max, u_max // 3, n).astype(np.int64)
    y = rng.integers(1, 1000, (n, u_max))
    y[np.arange(u_max)[None] >= y_len[:, None]] = 0
    return torch.from_numpy(y), torch.from_numpy(y_len)


def t_encoder_params() -> dict:
    from efficientconformer_torch.config import load_config

    return load_config(T_CONFIG)["encoder_params"]


def phase_t_requests():
    from efficientconformer_torch.config import encoder_output_frames
    from efficientconformer_torch.models import transducer as T

    t_enc = t_encoder_params()
    model = make_transducer("cuda", torch.bfloat16)
    x, x_len = ragged_audio(REQUEST_SECONDS, "cuda", np.random.default_rng(SEED))
    cap = T.greedy_token_cap(t_enc, x.shape[1], MAX_CONSEC)
    reset_rel_counts()
    tokens, counts = T.greedy_decode(model, x, x_len, cap, MAX_CONSEC)
    torch.cuda.synchronize()
    launches, tc = rel_counts()[:2]
    n_att = len(model.encoder.blocks)
    check(launches == n_att and tc == n_att, f"{launches} kernel launches for one encode, "
          f"{tc} on the tensor cores, expected {n_att} each")
    frame_tokens, frame_counts = T.greedy_decode(model, x, x_len, cap, MAX_CONSEC, algo="frame")
    check(torch.equal(tokens, frame_tokens) and torch.equal(counts, frame_counts),
          f"label loop {counts.tolist()} != frame loop {frame_counts.tolist()}")
    frames = [encoder_output_frames(t_enc, int(s * SAMPLE_RATE)) for s in REQUEST_SECONDS]
    counts = counts.tolist()
    check(all(0 < c <= MAX_CONSEC * f for c, f in zip(counts, frames)), f"counts {counts}")
    check(tokens.shape == (len(REQUEST_SECONDS), cap), f"tokens {tuple(tokens.shape)}")
    say("t-requests", seconds=list(REQUEST_SECONDS), frames=frames, tokens=counts, cap=cap,
        launches=launches, tc_launches=tc, frame_loop="equal")
    return launches, tc


def phase_t_slice():
    from efficientconformer_torch.models import transducer as T

    model = make_transducer("cuda", torch.float32)
    x, x_len = ragged_audio(REQUEST_SECONDS, "cuda", np.random.default_rng(SEED))
    y, y_len = t_batch_labels(len(REQUEST_SECONDS), 30, SEED)
    y = y.cuda()
    reset_rel_counts()
    with torch.inference_mode():
        logits_k, len_k = model(x, y, x_len, y_len.cuda())
        torch.cuda.synchronize()
        counts = rel_counts()[:2]
        check(counts == (len(model.encoder.blocks), 0), f"fp32 launches {counts}, expected "
              "every one on the FMA route")
        with plain_kernels():
            logits_p, len_p = model(x, y, x_len, y_len.cuda())
    check(torch.equal(len_k, len_p), f"lengths {len_k.tolist()} / {len_p.tolist()}")
    check(bool(torch.isfinite(logits_k).all()), "non-finite lattice logits")
    valid = torch.arange(logits_k.shape[1], device="cuda")[None, :] < len_k[:, None]
    err = (logits_k - logits_p).abs()[valid].max().item()
    check(err <= SLICE_TOL, f"kernel vs plain lattice |diff| {err} > {SLICE_TOL}")
    cpu_model = make_transducer("cpu", torch.float32)
    with torch.inference_mode():
        logits_c, _ = cpu_model(x.cpu(), y.cpu(), x_len.cpu(), y_len)
    err_cpu = (logits_k.cpu() - logits_c).abs()[valid.cpu()].max().item()
    check(err_cpu <= SLICE_TOL, f"card vs CPU lattice |diff| {err_cpu} > {SLICE_TOL}")
    agree = (logits_k.cpu().argmax(-1) == logits_c.argmax(-1))[valid.cpu()].float().mean().item()
    check(agree >= SLICE_ARGMAX_AGREEMENT, f"card vs CPU argmax agreement {agree}")

    cap = T.greedy_token_cap(t_encoder_params(), x.shape[1], MAX_CONSEC)
    tok_k, n_k = T.greedy_decode(model, x, x_len, cap, MAX_CONSEC)
    with plain_kernels():
        tok_p, n_p = T.greedy_decode(model, x, x_len, cap, MAX_CONSEC)
    check(torch.equal(tok_k, tok_p) and torch.equal(n_k, n_p),
          f"greedy tokens kernel {n_k.tolist()} vs plain {n_p.tolist()}")
    say("t-slice", dtype="float32", lattice=tuple(logits_k.shape), max_abs_diff=f"{err:.3g}",
        cpu_max_abs_diff=f"{err_cpu:.3g}", cpu_argmax_agreement=f"{agree:.6f}",
        greedy_tokens=n_k.tolist(), greedy_kernel_vs_plain="equal", route="fma")


def phase_t_rate(card_line: str):
    from efficientconformer_torch.models import transducer as T

    model = make_transducer("cuda", torch.bfloat16)
    n = int(TIME_SECONDS * SAMPLE_RATE)
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy((rng.standard_normal((T_RATE_BATCH, n)) * 0.1).astype(np.float32)).cuda()
    x_len = torch.full((T_RATE_BATCH,), n, device="cuda")
    cap = T.greedy_token_cap(t_encoder_params(), n, MAX_CONSEC)
    reset_rel_counts()
    T.greedy_decode(model, x, x_len, cap, MAX_CONSEC)
    torch.cuda.synchronize()
    launches, tc = rel_counts()[:2]
    check(launches == tc == len(model.encoder.blocks),
          f"rel-pos launches {launches}, {tc} on the tensor cores, for one batch")
    torch.cuda.reset_peak_memory_stats()
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        tokens, counts = T.greedy_decode(model, x, x_len, cap, MAX_CONSEC)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    check(bool((counts > 0).all()), "an utterance decoded to no token")
    say("t-rate", batch=T_RATE_BATCH, seconds=TIME_SECONDS, dtype="bfloat16", algo="label",
        ms_per_batch=f"{dt * 1e3:.2f}", audio_s_per_s=f"{T_RATE_BATCH * TIME_SECONDS / dt:.1f}",
        tokens_per_utt=f"{counts.float().mean().item():.1f}", token_cap=cap,
        loop_iterations=int(counts.max()) + 1,
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}", launches=launches,
        tc_launches=tc, card=f"'{card_line}'")


def launch_counts():
    from efficientconformer_torch.ops import rel_attention as RA
    from efficientconformer_torch.ops import rnnt_loss as RL

    return (RL.rnnt_alphas.launches, RL.rnnt_grads.launches, RA.relpos_attention.launches,
            RA.relpos_attention_bwd.launches)


def reset_launch_counts():
    from efficientconformer_torch.ops import bias_attention as BA
    from efficientconformer_torch.ops import rnnt_loss as RL

    RL.rnnt_alphas.launches = RL.rnnt_grads.launches = 0
    reset_rel_counts()
    BA.bias_attention.launches = BA.bias_attention_bwd.launches = 0
    BA.bias_attention.tc_launches = BA.bias_attention_bwd.tc_launches = 0


def bias_tc_counts():
    """Of the bias launches, those of the tensor-core route (bf16):
    (forward, backward)."""
    from efficientconformer_torch.ops import bias_attention as BA

    return BA.bias_attention.tc_launches, BA.bias_attention_bwd.tc_launches


def bias_launch_counts():
    from efficientconformer_torch.ops import bias_attention as BA

    return BA.bias_attention.launches, BA.bias_attention_bwd.launches


def phase_t_train_slice():
    cfg = train_config(T_CONFIG, mixed_precision=False, vn_start_step=None)
    cfg["encoder_params"].update(Pdrop=0.0, spec_augment=False)
    seconds = [[4.0, 5.5, 7.0, 8.0], [8.0, 6.5, 4.5, 5.0]]
    labels = [[12, 30, 10, 20], [25, 10, 18, 30]]
    batch = train_batch(2, 4, seconds, labels, "cpu", np.random.default_rng(SEED + 7))
    reset_launch_counts()
    kernel = one_step(cfg, "cuda", batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    n_att = cfg["encoder_params"]["num_blocks"] * 2
    check(counts == (2, 4, n_att, n_att), f"launches (RNN-T fwd, bwd, rel-pos fwd, bwd) "
          f"{counts}, expected (2, 4, {n_att}, {n_att}) for 2 microbatches (the RNN-T "
          f"backward: two kernels a call)")
    check(rel_counts()[1::2] == (0, 0), f"fp32 step: tensor-core launches {rel_counts()}")
    out = compare_steps(kernel, cfg, batch)
    say("t-train-slice", dtype="float32", loss=f"{kernel[0]:.6f}", grad_norm=f"{kernel[1]:.6f}",
        launches=counts, route="fma", **out)


def phase_t_train_learns():
    from efficientconformer_torch.training.trainer import Trainer

    cfg = train_config(T_CONFIG, lr_schedule="Constant", lr_value=1e-3)
    trainer = Trainer(cfg, device="cuda", seed=SEED)
    batch = train_batch(1, 8, 4.0, [10, 14, 18, 12, 16, 8, 20, 11], "cuda",
                        np.random.default_rng(SEED + 8))
    losses = trainer.fit(itertools.repeat(batch), LEARN_STEPS)
    check(all(math.isfinite(x) for x in losses), f"non-finite losses {losses}")
    check(losses[-1] < LEARN_RATIO * losses[0], f"loss {losses[0]} -> {losses[-1]}")
    say("t-train-learns", steps=LEARN_STEPS, batch="8x4s", first_loss=f"{losses[0]:.4f}",
        last_loss=f"{losses[-1]:.4f}", min_loss=f"{min(losses):.4f}")


def t_rate_trainer():
    """The Transducer config's own training step (bf16, dropout 0.1,
    SpecAugment, Adam + Transformer schedule) and its batch: 4 microbatches
    of 16 x 16 s with labels of 90 tokens, on the card."""
    from efficientconformer_torch.training.trainer import Trainer

    cfg = train_config(T_CONFIG)
    tp = cfg["training_params"]
    trainer = Trainer(cfg, device="cuda", seed=SEED)
    batch = train_batch(tp["accumulated_steps"], tp["batch_size"],
                        tp["train_audio_max_length"] / SAMPLE_RATE,
                        [tp["train_label_max_length"]], "cuda", np.random.default_rng(SEED + 9))
    return trainer, batch


def phase_t_train_rate(card_line: str):
    trainer, batch = t_rate_trainer()
    accum, b, t = batch["audio"].shape
    trainer.train_step(batch)
    torch.cuda.synchronize()
    reset_launch_counts()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    n_att = trainer.config["encoder_params"]["num_blocks"] * accum
    check(counts == (accum, 2 * accum, n_att, n_att), f"launches (RNN-T fwd, bwd, rel-pos "
          f"fwd, bwd) {counts} in one step, expected ({accum}, {2 * accum}, {n_att}, {n_att}) "
          f"(the RNN-T backward: two kernels a call)")
    tc = rel_counts()[1::2]
    check(tc == (n_att, n_att), f"rel-pos tensor-core launches {tc}, expected every launch")
    torch.cuda.reset_peak_memory_stats()
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        loss, grad_norm = trainer.train_step(batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    check(math.isfinite(float(loss)) and math.isfinite(float(grad_norm)), f"loss {float(loss)}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    # one step with the config's variational noise on (from vn_start_step)
    trainer.step = trainer.vn_start_step
    t0 = time.perf_counter()
    loss_vn, _ = trainer.train_step(batch)
    torch.cuda.synchronize()
    dt_vn = time.perf_counter() - t0
    check(math.isfinite(float(loss_vn)), f"VN step loss {float(loss_vn)}")
    audio_s = accum * b * t / SAMPLE_RATE
    say("t-train-rate", microbatches=accum, batch=b, seconds=t / SAMPLE_RATE,
        labels=batch["labels"].shape[-1], dtype="bfloat16", ms_per_step=f"{dt * 1e3:.2f}",
        audio_s_per_s=f"{audio_s / dt:.1f}", peak_mem_gib=f"{peak:.2f}",
        loss=f"{float(loss):.4f}", grad_norm=f"{float(grad_norm):.4f}",
        launches=counts, tc_launches=tc, vn_step_ms=f"{dt_vn * 1e3:.2f}",
        vn_loss=f"{float(loss_vn):.4f}", card=f"'{card_line}'")
    return counts + tc


# ---------------------------------------------------------------- LM-Transformer


def lm_params() -> dict:
    from efficientconformer_torch.config import load_config

    return load_config(LM_CONFIG)["lm_params"]


def bias_inputs(b, h, nq, nk, dqk, dv, layout, gen, masked_row=False):
    """(q, k, v, bias, scale) on the card. q, k, v are head-split views of
    (B, N, H, d) projections, as the attention module passes them. The
    bias: "causal", the LM's (B, H, N, N) rel-pos scores plus its causal and
    ragged padding mask; "batch" (B, 1, Nq, Nk) and "head" (1, H, Nq, Nk)
    broadcasts of such scores; "keymask" (B, 1, 1, Nk). ``masked_row`` masks
    every key of query row 1 of the first (batch, head)."""
    from efficientconformer_torch.ops import masks as M
    from efficientconformer_torch.ops.attention import NEG_INF

    def heads(n, w):
        return torch.randn(b, n, h, w, generator=gen).cuda().transpose(1, 2)

    q, k, v = heads(nq, dqk), heads(nk, dqk), heads(nk, dv)
    lengths = torch.linspace(max(nk // 3, 1), nk, b).round().long()
    shape = {"causal": (b, h, nq, nk), "batch": (b, 1, nq, nk), "head": (1, h, nq, nk),
             "keymask": (b, 1, 1, nk)}[layout]
    bias = torch.randn(shape, generator=gen) if layout != "keymask" else torch.zeros(shape)
    if layout == "causal":
        bias = bias + M.look_ahead_mask(nq, lengths) * NEG_INF
    elif layout != "head":
        bias = bias + M.padding_mask(nk, lengths) * NEG_INF
    if masked_row:
        bias[0, 0, 1] = NEG_INF
    return q, k, v, bias.cuda(), 1.0 / math.sqrt(dqk)


def bias_grad_errors(got, want):
    """max |diff| / max(max|want|, 1) of dq, dk, dv and dS."""
    return {n: (g.float() - w.float()).abs().max().item() / max(w.abs().max().item(), 1.0)
            for n, g, w in zip(("dq", "dk", "dv", "ds"), got, want)}


def check_bias_case(name, args, gen):
    """Both bias kernels vs their plain versions on ``args``: fp32 (O, LSE;
    the four gradients on the same dO), then bf16 on bf16-rounded q, k, v
    (the plain versions compute in fp32 from the same bf16 inputs, so the
    difference is the kernels' bf16 outputs, 8 mantissa bits, plus the fp32
    order; the JAX package's XLA route also rounds P to bf16 before P V,
    which neither does). The largest fp32 errors, forward and backward."""
    from efficientconformer_torch.ops import bias_attention as BA

    q, k, v, bias, scale = args
    reset_launch_counts()
    o, lse = BA.bias_attention_fwd(*args)
    want_o, want_lse = BA.reference_bias_attention(*args)
    do = torch.randn(o.shape, generator=gen).cuda()
    got = BA.bias_attention_bwd(q, k, v, bias, o, do, lse, scale)
    want = BA.reference_bias_attention_bwd(q, k, v, bias, do, scale)
    torch.cuda.synchronize()
    err_o = (o - want_o).abs().max().item()
    err_lse = (lse - want_lse).abs().max().item()
    check(err_o <= KERNEL_FP32_TOL and err_lse <= KERNEL_FP32_TOL,
          f"{name} fp32: |O| {err_o} |LSE| {err_lse} > {KERNEL_FP32_TOL}")
    err = bias_grad_errors(got, want)
    check(max(err.values()) <= GRAD_TOL, f"{name} fp32 backward: {err} > {GRAD_TOL}")
    check(bias_tc_counts() == (0, 0), f"{name} fp32 went through the tensor-core kernels")

    q16, k16, v16 = (t.to(torch.bfloat16) for t in (q, k, v))
    o16, lse16 = BA.bias_attention_fwd(q16, k16, v16, bias, scale)
    want16, _ = BA.reference_bias_attention(q16, k16, v16, bias, scale)
    err16 = (o16.float() - want16.float()).abs().max().item()
    check(o16.dtype == torch.bfloat16 and err16 <= KERNEL_BF16_TOL,
          f"{name} bf16: |O| {err16} > {KERNEL_BF16_TOL}")
    got16 = BA.bias_attention_bwd(q16, k16, v16, bias, o16, do.bfloat16(), lse16, scale)
    want16 = BA.reference_bias_attention_bwd(q16, k16, v16, bias, do.bfloat16(), scale)
    err16b = bias_grad_errors(got16, want16)
    check(got16[0].dtype == torch.bfloat16 and max(err16b.values()) <= GRAD_BF16_TOL,
          f"{name} bf16 backward: {err16b} > {GRAD_BF16_TOL}")
    check(bias_launch_counts() == (2, 2) and bias_tc_counts() == (1, 1),
          f"{name}: launches {bias_launch_counts()}, tensor-core {bias_tc_counts()}, "
          "expected the bf16 pair on the tensor cores")
    say("lm-kernel", case=name, B=q.shape[0], H=q.shape[1], Nq=q.shape[2], Nk=k.shape[2],
        dqk=q.shape[3], dv=v.shape[3], bias=tuple(bias.shape), fp32_err_o=f"{err_o:.3g}",
        fp32_err_lse=f"{err_lse:.3g}", fp32_bwd_rel_err=f"{max(err.values()):.3g}",
        bf16_err_o=f"{err16:.3g}", bf16_bwd_rel_err=f"{max(err16b.values()):.3g}")
    return max(err_o, err_lse), max((a.float() - b.float()).abs().max().item()
                                    for a, b in zip(got, want))


def bias_cost(b, h, nq, nk, dqk, dv, itemsize, backward):
    """(FLOPs, bytes) of the bias attention: the dense products (forward
    q k^T and P V; backward the scores again, dP, dv, dq and dk) and each
    input read once and each output written once: q, k, v, O (and dO, dq,
    dk, dv) in the input type, the bias and dS in fp32, the LSE in fp64."""
    qk, ov = b * h * nq * dqk * itemsize, b * h * nq * dv * itemsize
    kk, vv = b * h * nk * dqk * itemsize, b * h * nk * dv * itemsize
    scores, lse = b * h * nq * nk * 4, b * h * nq * 8
    if backward:
        return (2 * b * h * nq * nk * (3 * dqk + 2 * dv),
                qk + kk + vv + 2 * ov + scores + lse + qk + kk + vv + scores)
    return 2 * b * h * nq * nk * (dqk + dv), qk + kk + vv + scores + ov + lse


def phase_lm_kernel():
    """Both bias kernels checked on the LM's shapes and the other bias
    layouts, then timed at the LM's training shape (B 64, bf16), beside the
    plain versions, the bound and scaled_dot_product_attention with the same
    bias as attn_mask (in bf16, the type it takes; forward + backward with
    the mask requiring a gradient, as the LM's bias does). Each is timed
    from a CUDA graph (device time, graph_ms: the kernels' ms) and from
    back-to-back eager calls (cuda_ms: *_call_ms, the host's time per call
    included)."""
    from efficientconformer_torch.ops import bias_attention as BA

    p = lm_params()
    h, dh, n = p["num_heads"], p["dim_model"] // p["num_heads"], 101
    gen = torch.Generator().manual_seed(SEED + 10)
    err_f = err_b = 0.0
    for name, b, hh, nq, dqk, dv, layout, masked in (
            ("lm-causal", LM_CHECK_BATCH, h, n, dh, dh, "causal", False),
            ("batch-bias", LM_CHECK_BATCH, h, n, dh, dh, "batch", False),
            ("head-bias", LM_CHECK_BATCH, h, n, dh, dh, "head", False),
            ("keymask", LM_CHECK_BATCH, h, n, dh, dh, "keymask", False),
            ("dqk90-dv70", 4, 4, 130, 90, 70, "causal", False),
            ("masked-row", LM_CHECK_BATCH, h, n, dh, dh, "causal", True)):
        args = bias_inputs(b, hh, nq, nq, dqk, dv, layout, gen, masked)
        ef, eb = check_bias_case(name, args, gen)
        err_f, err_b = max(err_f, ef), max(err_b, eb)

    q, k, v, bias, scale = bias_inputs(LM_TIME_BATCH, h, n, n, dh, dh, "causal", gen)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    o, lse = BA.bias_attention_fwd(q, k, v, bias, scale)
    do = torch.randn(o.shape, generator=gen).to("cuda", torch.bfloat16)
    mask16 = bias.to(torch.bfloat16)
    lq, lk, lv, lmask = (t.detach().clone().requires_grad_() for t in (q, k, v, mask16))

    def library_bwd():
        out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lmask, scale=scale)
        return torch.autograd.grad(out, (lq, lk, lv, lmask), do)

    check(library_bwd()[3] is not None, "scaled_dot_product_attention gave the mask no gradient")
    calls = {"forward": {
        "kernel": lambda: BA.bias_attention_fwd(q, k, v, bias, scale),
        "plain": lambda: BA.reference_bias_attention(q, k, v, bias, scale),
        "library": lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask16,
                                                          scale=scale)}, "backward": {
        "kernel": lambda: BA.bias_attention_bwd(q, k, v, bias, o, do, lse, scale),
        "plain": lambda: BA.reference_bias_attention_bwd(q, k, v, bias, do, scale),
        "library": library_bwd}}
    rows = {}
    for label, fns in calls.items():
        backward = label == "backward"
        row = {name: graph_ms(fn) for name, fn in fns.items()}
        per_call = {f"{name}_call": cuda_ms(fn) for name, fn in fns.items()}
        row["bound"], row["bound_by"] = bound(*bias_cost(LM_TIME_BATCH, h, n, n, dh, dh, 2,
                                                         backward))
        say("lm-kernel-time", direction=label, B=LM_TIME_BATCH, H=h, N=n, dh=dh,
            dtype="bfloat16", bound_by=row["bound_by"],
            library="sdpa fwd" if not backward else "sdpa fwd+bwd, mask grad",
            **{f"{k}_ms": f"{v:.4f}" for k, v in {**row, **per_call}.items() if k != "bound_by"})
        rows[label] = row
    return err_f, rows["forward"], err_b, rows["backward"]


def make_lm(device, dtype):
    """The LM-Transformer at full width and depth, weights from SEED, with
    non-trivial LayerNorm parameters."""
    from efficientconformer_torch.models.lm import build_model

    return perturb_norms_(build_model(LM_CONFIG, device, dtype,
                                      torch.Generator().manual_seed(SEED)))


def lm_batch(accum, batch, lengths, device, rng):
    """Stacked LM microbatches (accum, batch, ...): random tokens in [1, V)
    of the given lengths, 0 past them; targets the tokens, then 0, then -1
    (data/loader.py:223-229)."""
    vocab = lm_params()["vocab_size"]
    n = np.broadcast_to(np.asarray(lengths, dtype=np.int64), (accum, batch)).copy()
    u = int(n.max())
    tokens = rng.integers(1, vocab, (accum, batch, u))
    past = np.arange(u)[None, None, :] >= n[..., None]
    tokens[past] = 0
    targets = np.full((accum, batch, u + 1), -1, np.int64)
    targets[..., :u] = np.where(past, -1, tokens)
    np.put_along_axis(targets, n[..., None], 0, axis=-1)
    return {"tokens": torch.from_numpy(tokens).to(device),
            "token_len": torch.from_numpy(n).to(device),
            "targets": torch.from_numpy(targets).to(device)}


def phase_lm_slice():
    from efficientconformer_torch.ops import bias_attention as BA

    model = make_lm("cuda", torch.float32)
    lengths = np.linspace(*LM_SLICE_LENGTHS, LM_CHECK_BATCH).round().astype(np.int64)
    mb = {k: v[0] for k, v in lm_batch(1, LM_CHECK_BATCH, lengths, "cuda",
                                        np.random.default_rng(SEED)).items()}
    reset_launch_counts()
    with torch.inference_mode():
        logits_k = model(mb["tokens"], mb["token_len"])
        torch.cuda.synchronize()
        launches, tc = BA.bias_attention.launches, BA.bias_attention.tc_launches
        with plain_kernels():
            logits_p = model(mb["tokens"], mb["token_len"])
    n_blocks = lm_params()["num_blocks"]
    check(launches == n_blocks and tc == 0, f"{launches} bias kernel launches for one "
          f"forward, {tc} of them on the tensor cores, expected {n_blocks} on the FMA route")
    check(bool(torch.isfinite(logits_k).all()), "non-finite LM logits")
    valid = (torch.arange(logits_k.shape[1], device="cuda")[None, :]
             <= mb["token_len"][:, None])
    err = (logits_k - logits_p).abs()[valid].max().item()
    check(err <= SLICE_TOL, f"kernel vs plain LM logits |diff| {err} > {SLICE_TOL}")
    cpu_model = make_lm("cpu", torch.float32)
    with torch.inference_mode():
        logits_c = cpu_model(mb["tokens"].cpu(), mb["token_len"].cpu())
    err_cpu = (logits_k.cpu() - logits_c).abs()[valid.cpu()].max().item()
    agree = (logits_k.cpu().argmax(-1) == logits_c.argmax(-1))[valid.cpu()].float().mean().item()
    check(err_cpu <= SLICE_TOL, f"card vs CPU LM logits |diff| {err_cpu} > {SLICE_TOL}")
    check(agree >= SLICE_ARGMAX_AGREEMENT, f"card vs CPU argmax agreement {agree}")
    say("lm-slice", dtype="float32", logits=tuple(logits_k.shape), lengths=lengths.tolist(),
        max_abs_diff=f"{err:.3g}", cpu_max_abs_diff=f"{err_cpu:.3g}",
        cpu_argmax_agreement=f"{agree:.6f}", launches=launches, route="fma")


def lm_score_setup():
    """The LM config's trainer (bf16, its mixed_precision) and one scoring
    batch of 64 full-length sequences (100 tokens + the blank)."""
    from efficientconformer_torch.training.trainer import Trainer

    cfg = train_config(LM_CONFIG)
    tp = cfg["training_params"]
    trainer = Trainer(cfg, device="cuda", seed=SEED)
    batch = lm_batch(1, LM_TIME_BATCH, [tp["train_label_max_length"]], "cuda",
                     np.random.default_rng(SEED + 11))
    return trainer, {k: v[0] for k, v in batch.items()}


def phase_lm_score_rate(card_line: str):
    trainer, mb = lm_score_setup()
    for _ in range(2):
        trainer.eval_loss(mb)
    torch.cuda.synchronize()
    reset_launch_counts()
    loss = trainer.eval_loss(mb)
    torch.cuda.synchronize()
    fwd, bwd = bias_launch_counts()
    tc = bias_tc_counts()
    n_blocks = lm_params()["num_blocks"]
    check((fwd, bwd) == (n_blocks, 0), f"bias launches {fwd}/{bwd} for one scoring batch, "
          f"expected {n_blocks}/0")
    check(tc == (n_blocks, 0), f"tensor-core launches {tc}, expected every bias launch")
    torch.cuda.reset_peak_memory_stats()
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        loss = trainer.eval_loss(mb)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    tokens = int((mb["token_len"] + 1).sum())
    check(math.isfinite(float(loss)), f"eval loss {float(loss)}")
    say("lm-score-rate", batch=LM_TIME_BATCH, positions=mb["targets"].shape[-1],
        dtype="bfloat16", ms_per_batch=f"{dt * 1e3:.3f}", tokens_per_s=f"{tokens / dt:.1f}",
        eval_loss=f"{float(loss):.4f}", perplexity=f"{math.exp(min(float(loss), 30.0)):.2f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}", launches=fwd,
        tc_launches=tc[0], card=f"'{card_line}'")
    return fwd


def phase_lm_train_slice():
    cfg = train_config(LM_CONFIG, mixed_precision=False)
    cfg["lm_params"]["Pdrop"] = 0.0
    lengths = [[20, 55, 100, 10], [70, 35, 90, 45]]
    batch = lm_batch(2, 4, lengths, "cpu", np.random.default_rng(SEED + 12))
    reset_launch_counts()
    kernel = one_step(cfg, "cuda", batch)
    torch.cuda.synchronize()
    counts = bias_launch_counts()
    n_att = cfg["lm_params"]["num_blocks"] * 2
    check(counts == (n_att, n_att), f"bias launches (fwd, bwd) {counts}, expected "
          f"({n_att}, {n_att}) for 2 microbatches")
    check(bias_tc_counts() == (0, 0), f"fp32 step: tensor-core launches {bias_tc_counts()}")
    out = compare_steps(kernel, cfg, batch)
    say("lm-train-slice", dtype="float32", loss=f"{kernel[0]:.6f}", grad_norm=f"{kernel[1]:.6f}",
        launches=counts, route="fma", **out)


def phase_lm_train_learns():
    from efficientconformer_torch.training.trainer import Trainer

    lr = train_config(LM_CONFIG)["training_params"]["lr_max"]
    cfg = train_config(LM_CONFIG, lr_schedule="Constant", lr_value=lr)
    trainer = Trainer(cfg, device="cuda", seed=SEED)
    lengths = np.linspace(20, 60, 8).round().astype(np.int64)
    batch = lm_batch(1, 8, lengths, "cuda", np.random.default_rng(SEED + 13))
    losses = trainer.fit(itertools.repeat(batch), LEARN_STEPS)
    check(all(math.isfinite(x) for x in losses), f"non-finite losses {losses}")
    check(losses[-1] < LEARN_RATIO * losses[0], f"loss {losses[0]} -> {losses[-1]}")
    say("lm-train-learns", steps=LEARN_STEPS, batch="8x20-60", lr=lr,
        first_loss=f"{losses[0]:.4f}", last_loss=f"{losses[-1]:.4f}",
        min_loss=f"{min(losses):.4f}")


def lm_rate_trainer():
    """The LM config's own training step (bf16, dropout 0.1, Adam with betas
    0.9/0.95 under the Cosine schedule) and its batch: 5 microbatches of 64
    sequences of 100 tokens, on the card."""
    from efficientconformer_torch.training.trainer import Trainer

    cfg = train_config(LM_CONFIG)
    tp = cfg["training_params"]
    trainer = Trainer(cfg, device="cuda", seed=SEED)
    batch = lm_batch(tp["accumulated_steps"], tp["batch_size"], [tp["train_label_max_length"]],
                     "cuda", np.random.default_rng(SEED + 14))
    return trainer, batch


def lm_step_flops(trainer, batch) -> float:
    """Model FLOPs of one step: 6 per parameter per token for the matrix
    products, plus the attention's (B, H, T, T) products (q k^T, P V and the
    rel-pos scores qv e^T), three times for forward and backward."""
    p = trainer.config["lm_params"]
    accum, b, u = batch["tokens"].shape
    t, d = u + 1, p["dim_model"]
    n_params = sum(x.numel() for x in trainer.model.parameters())
    attention = 3 * p["num_blocks"] * accum * 2 * b * t * t * d * 3
    return 6 * n_params * accum * b * t + attention


def phase_lm_train_rate(card_line: str):
    trainer, batch = lm_rate_trainer()
    accum, b, u = batch["tokens"].shape
    trainer.train_step(batch)
    torch.cuda.synchronize()
    reset_launch_counts()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    counts = bias_launch_counts()
    tc = bias_tc_counts()
    n_att = trainer.config["lm_params"]["num_blocks"] * accum
    check(counts == (n_att, n_att), f"bias launches (fwd, bwd) {counts} in one step, "
          f"expected ({n_att}, {n_att})")
    check(tc == counts, f"tensor-core launches {tc}, expected every bias launch {counts}")
    torch.cuda.reset_peak_memory_stats()
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        loss, grad_norm = trainer.train_step(batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    check(math.isfinite(float(loss)) and math.isfinite(float(grad_norm)), f"loss {float(loss)}")
    tokens = accum * b * (u + 1)
    flops = lm_step_flops(trainer, batch)
    say("lm-train-rate", microbatches=accum, batch=b, positions=u + 1, dtype="bfloat16",
        ms_per_step=f"{dt * 1e3:.2f}", tokens_per_s=f"{tokens / dt:.1f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        loss=f"{float(loss):.4f}", grad_norm=f"{float(grad_norm):.4f}", launches=counts,
        tc_launches=tc, model_tflop=f"{flops / 1e12:.2f}",
        bf16_peak_share=f"{flops / dt / BF16_PEAK:.4f}",
        card=f"'{card_line}'")
    return counts


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
    from efficientconformer_torch.models import transducer as T
    from efficientconformer_torch.models.model_ctc import greedy_decode

    n = int(TIME_SECONDS * SAMPLE_RATE)
    audio = (np.random.default_rng(SEED).standard_normal((TIME_BATCH, n)) * 0.1).astype(np.float32)
    x = torch.from_numpy(audio).cuda()
    x_len = torch.full((TIME_BATCH,), n, device="cuda")
    model = make_model("cuda", torch.bfloat16)
    t_model = make_transducer("cuda", torch.bfloat16)
    cap = T.greedy_token_cap(t_encoder_params(), n, MAX_CONSEC)
    trainer, batch = rate_trainer()
    t_trainer, t_batch = t_rate_trainer()
    lm_scorer, lm_mb = lm_score_setup()
    lm_trainer, lm_train_batch = lm_rate_trainer()
    paths = {"infer": lambda: greedy_decode(model, x, x_len),
             "train": lambda: trainer.train_step(batch),
             "t-infer": lambda: T.greedy_decode(t_model, x[:T_RATE_BATCH], x_len[:T_RATE_BATCH],
                                                cap, MAX_CONSEC),
             "t-train": lambda: t_trainer.train_step(t_batch),
             "lm-score": lambda: lm_scorer.eval_loss(lm_mb),
             "lm-train": lambda: lm_trainer.train_step(lm_train_batch)}
    walls = {label: wall_ms(fn) for label, fn in paths.items()}
    for label, fn in paths.items():
        profile(label, fn, walls[label])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also print a torch.profiler breakdown of every path")
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
    from efficientconformer_torch.ops import bias_attention as BA
    from efficientconformer_torch.ops import rnnt_loss as RL

    t0 = time.perf_counter()
    kernels = (RA.KERNEL, RA.KERNEL_BWD, RL.KERNEL_FWD, RL.KERNEL_BWD, BA.KERNEL, BA.KERNEL_BWD)
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
        reports = list(pool.map(_kernels.build, kernels))
    for name in kernels:
        _kernels.load(name)
    say("build", kernels=",".join(kernels), seconds=f"{time.perf_counter() - t0:.2f}")
    for line in "\n".join(reports).splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    # the rel-pos kernels' shared memory is dynamic, so ptxas does not report it
    enc_params = load_config(CONFIG)["encoder_params"]
    t_cfg = load_config(T_CONFIG)
    # at the stage shapes of all twelve ASR configs (ROADMAP Queue 1 item 16),
    # on both routes
    for path in ASR_CONFIGS:
        for name, n, dh, d, h, g in stage_shapes(load_config(path)["encoder_params"],
                                                 TRAIN_SECONDS):
            row = {}
            for dtype, route in ((torch.bfloat16, "tc"), (torch.float32, "fma")):
                fwd_b, bwd_b = RA.smem_bytes(dtype, dh, d)
                takes = [RA.refusal(dtype, dh, d, backward) is None for backward in (0, 1)]
                row.update({f"{route}_fwd_bytes": fwd_b, f"{route}_bwd_bytes": bwd_b,
                            f"{route}_takes": "both" if all(takes) else
                            "forward" if takes[0] else "no"})
            say("build-smem", config=path.split("/")[-1].removesuffix(".json"), shape=name,
                dh=dh, rel_width=d, limit=RA.SMEM_LIMIT, **row)

    dh = lm_params()["dim_model"] // lm_params()["num_heads"]
    for dtype, route in ((torch.bfloat16, "tensor-core"), (torch.float32, "fma")):
        for n in (101, 130):   # the LM's N, and the two-pass backward's
            fwd_b, bwd_b = BA.smem_bytes(dtype, n, dh, dh)
            say("build-smem", config="LM-Transformer", kernels="bias_attention", route=route,
                N=n, dh=dh, fwd_bytes=fwd_b,
                bwd_bytes="/".join(map(str, bwd_b)) + (" (one pass)" if len(bwd_b) == 1 else ""))

    for u1 in (91, 150, 1024):   # the Transducer's U+1, RNNT_WIDE's, and the most taken
        threads, ring, smem = RL.launch_geometry(u1)
        say("build-smem", kernels="rnnt_fwd,rnnt_bwd", U1=u1, threads=threads, ring=ring,
            bytes=smem, limit=RL.SMEM_LIMIT)

    max_err, err16, times = phase_kernel(enc_params)
    max_err_bwd, err16_bwd, times_bwd = phase_kernel_bwd(enc_params)
    launches, fwd_tc = phase_requests()
    phase_slice()
    phase_rate(card_line)
    phase_train_slice()
    phase_train_learns()
    launches_bwd, tc_bwd = phase_train_rate(card_line)
    (t_err, t_err16), (t_err_bwd, t_err16_bwd) = phase_t_kernel(t_cfg["encoder_params"])
    err_rnnt, times_rnnt, err_rnnt_bwd, times_rnnt_bwd = phase_rnnt_kernel(t_cfg)
    t_launches, t_tc = phase_t_requests()
    phase_t_slice()
    phase_t_rate(card_line)
    phase_t_train_slice()
    phase_t_train_learns()
    rnnt_fwd, rnnt_bwd, t_fwd, t_bwd, t_fwd_tc, t_bwd_tc = phase_t_train_rate(card_line)
    check(t_launches > 0 and t_fwd > 0 and t_bwd > 0, "the Transducer paths missed a kernel")
    check(t_tc == t_launches and t_fwd_tc == t_fwd and t_bwd_tc == t_bwd,
          "a bf16 Transducer path missed the tensor-core route")
    err_bias, times_bias, err_bias_bwd, times_bias_bwd = phase_lm_kernel()
    phase_lm_slice()
    lm_score_launches = phase_lm_score_rate(card_line)
    phase_lm_train_slice()
    phase_lm_train_learns()
    lm_fwd, lm_bwd = phase_lm_train_rate(card_line)
    check(lm_score_launches > 0 and lm_fwd > 0 and lm_bwd > 0, "the LM paths missed a kernel")
    if opts.profile:
        phase_profile()

    # bias_attention_fwd also replaces _flash_kernel (pallas_attention.py:272),
    # bias_attention_bwd also _bwd_dkv_kernel (:446)
    def entry(name, source, replaces, n, err, t, **extra):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n, "max_abs_err": err, "ms": t["kernel"], "plain_ms": t["plain"],
                "bound_ms": t["bound"], "bound_by": t["bound_by"], "library_ms": t["library"],
                **extra}

    # the rel-pos entries: ms and library_ms from CUDA graphs (device time),
    # eager_ms per eager call; max_abs_err fp32 (the FMA route), bf16_max_err
    # the tensor-core route's (the backward's relative to max(max|g|, 1))
    print(json.dumps({"kernels": [
        entry(RA.KERNEL, "efficientconformer_torch/csrc/rel_attention_fwd.cu",
              "efficientconformer_tpu/ops/pallas_rel_attention.py:122", launches,
              max(max_err, t_err), times, bf16_max_err=max(err16, t_err16),
              tc_launches=fwd_tc, graph_ms=times["kernel"], eager_ms=times["kernel_call"]),
        entry(RA.KERNEL_BWD, "efficientconformer_torch/csrc/rel_attention_bwd.cu",
              "efficientconformer_tpu/ops/pallas_rel_attention.py:139", launches_bwd,
              max(max_err_bwd, t_err_bwd), times_bwd,
              bf16_max_err=max(err16_bwd, t_err16_bwd), tc_launches=tc_bwd,
              graph_ms=times_bwd["kernel"], eager_ms=times_bwd["kernel_call"]),
        entry(RL.KERNEL_FWD, "efficientconformer_torch/csrc/rnnt_fwd.cu",
              "efficientconformer_tpu/ops/pallas_rnnt.py:73", rnnt_fwd, err_rnnt, times_rnnt),
        entry(RL.KERNEL_BWD, "efficientconformer_torch/csrc/rnnt_bwd.cu",
              "efficientconformer_tpu/ops/pallas_rnnt.py:96", rnnt_bwd, err_rnnt_bwd,
              times_rnnt_bwd),
        entry(BA.KERNEL, "efficientconformer_torch/csrc/bias_attention_fwd.cu",
              "efficientconformer_tpu/ops/pallas_attention.py:55", lm_fwd, err_bias, times_bias),
        entry(BA.KERNEL_BWD, "efficientconformer_torch/csrc/bias_attention_bwd.cu",
              "efficientconformer_tpu/ops/pallas_attention.py:412", lm_bwd, err_bias_bwd,
              times_bias_bwd),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
