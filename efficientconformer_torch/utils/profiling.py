"""``--profiler``: a trace of the eval_time modes and its top-op table.

Counterpart of efficientconformer_tpu/utils/profiling.py and its use in
runtime.py:576-630, after the original's ``--profiler`` (reference
models/model.py:613-622), which prints torch.autograd.profiler's
``key_averages().table(sort_by="cpu_time_total", row_limit=10)``.
``trace`` runs ``torch.profiler`` over the timed work, with CPU activity and,
on the card, CUDA activity, and writes the Chrome trace to
``<log_dir>/trace.json``. ``print_trace_summary`` prints the top 10 rows in
the JAX package's table (``format_op_table`` is its copy): on the card the
kernels by device time (the hand-written kernels, launched through ctypes,
appear under their own names, e.g. ``relpos_fwd_tc_kernel<64>``); on the CPU
the operators by self CPU time. On the card a trace without device rows
raises: it would hide the kernels.
"""

from __future__ import annotations

import contextlib
import os
from typing import List, Tuple

import torch


@contextlib.contextmanager
def trace(log_dir: str, device: torch.device):
    """Profile the body on ``device``'s activities; yields the profiler,
    whose Chrome trace is written to ``<log_dir>/trace.json`` on exit."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def summarize(prof, device: torch.device, top: int = 10) -> List[Tuple[str, float, int]]:
    """[(op, total_us, count)] of the ``top`` rows by total time: CUDA
    kernels by self device time on the card (user annotations left out,
    their kernels count already), operators by self CPU time on the CPU."""
    rows = []
    for e in prof.key_averages():
        if device.type == "cuda":
            if (e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
                    and not getattr(e, "is_user_annotation", False)):
                rows.append((e.key, float(e.self_device_time_total), e.count))
        elif e.self_cpu_time_total > 0:
            rows.append((e.key, float(e.self_cpu_time_total), e.count))
    if device.type == "cuda" and not rows:
        raise RuntimeError("profiler: the trace holds no device time; the kernels would not "
                           "show")
    return sorted(rows, key=lambda r: -r[1])[:top]


def format_op_table(rows: List[Tuple[str, float, int]]) -> str:
    """Render [(op, total_us, count)] as the reference-style table."""
    total = sum(t for _, t, _ in rows) or 1.0
    name_w = max([len(n) for n, _, _ in rows] + [4])
    name_w = min(name_w, 48)
    lines = [
        f"{'Op':<{name_w}}  {'Total':>12}  {'Avg':>10}  {'Calls':>6}  {'%':>6}",
        "-" * (name_w + 42),
    ]
    for n, t, c in rows:
        lines.append(
            f"{n[:name_w]:<{name_w}}  {t/1e3:>10.3f}ms  {t/c/1e3:>8.3f}ms  "
            f"{c:>6}  {100*t/total:>5.1f}%"
        )
    return "\n".join(lines)


def print_trace_summary(prof, log_dir: str, device: torch.device, top: int = 10) -> None:
    """Print the top-op table of ``prof``, naming where its trace lies."""
    rows = summarize(prof, device, top)
    kind = "kernels by device time" if device.type == "cuda" else "ops by self CPU time"
    print(f"profiler: top {len(rows)} {kind} ({log_dir}):")
    print(format_op_table(rows))
