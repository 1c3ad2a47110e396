"""The port's ``--profiler`` (utils/profiling.py), on the CPU.

The top-op table's format against the JAX package's ``format_op_table`` on
the same rows, and the CLI's ``eval_time --profiler --cpu`` on the
mini-LibriSpeech of tests/test_e2e.py: ten rows of the table, printed
before the time, and the trace under ``<callback_path>/profile/``.
"""

import contextlib
import io
import json
import os
import re

import pytest
import torch

from efficientconformer_tpu.utils.profiling import format_op_table as jax_format_op_table
from efficientconformer_torch import main as cli
from efficientconformer_torch.utils import profiling
from test_torch_port_checkpoint import tiny_config
from test_torch_port_runtime import prepare

ROWS = [
    [("aten::mm", 1234.5, 10), ("aten::add", 10.0, 3), ("x" * 80, 0.25, 1)],
    [("relpos_fwd_tc_kernel<64>", 626.9, 15)],
    [("a", 0.0, 1), ("b", 0.0, 2)],
]


@pytest.mark.parametrize("rows", ROWS, ids=["mixed", "one", "zero"])
def test_format_op_table_is_the_jax_table(rows):
    assert profiling.format_op_table(rows) == jax_format_op_table(rows)


def test_summary_by_self_cpu_time_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path / "profile"), torch.device("cpu")) as prof:
        x = torch.randn(64, 64)
        for _ in range(3):
            x = torch.tanh(x @ x)
    assert (tmp_path / "profile" / "trace.json").exists()
    rows = profiling.summarize(prof, torch.device("cpu"), top=4)
    assert 1 <= len(rows) <= 4 and [r[1] for r in rows] == sorted((r[1] for r in rows),
                                                                  reverse=True)
    assert any("mm" in name for name, _, _ in rows)


def test_eval_time_profiler_prints_the_table_and_writes_the_trace(tmp_path):
    root = str(tmp_path / "LibriSpeech")
    cfg = tiny_config(tmp_path, root)
    prepare(root, cfg)
    cfg["training_params"]["callback_path"] = str(tmp_path / "cb") + "/"
    path = tmp_path / "ctc.json"
    path.write_text(json.dumps(cfg))
    out = io.StringIO()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(out):
            assert cli.main(["--cpu", "-c", str(path), "-m", "eval_time", "--profiler",
                             "--batch_size_eval", "3", "--val_steps", "1"]) == 0
    finally:
        torch.set_num_threads(n)
    text = out.getvalue()
    head = re.search(r"profiler: top (\d+) ops by self CPU time \((.*)\):\n", text)
    assert head and int(head.group(1)) == 10, text
    table = text[head.end():].split("\neval time : ")[0].splitlines()
    assert table[0].split() == ["Op", "Total", "Avg", "Calls", "%"]
    assert len(table) == 2 + 10
    assert re.search(r"eval time : [\d.]+s", text)
    assert head.group(2) == os.path.join(str(tmp_path / "cb"), "profile")
    trace = os.path.join(head.group(2), "trace.json")
    assert os.path.getsize(trace) > 0
    with open(trace) as f:
        assert json.load(f)["traceEvents"]
