"""Guards of the PyTorch port: the weight bridge round trip, that the port
runs without JAX, and that chip_smoke.py has no CPU fallback."""

import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from efficientconformer_tpu.utils import torch_compat as TC
from efficientconformer_torch.models.model_ctc import ModelCTC, build_model
from efficientconformer_torch.ops import rel_attention as RA
from efficientconformer_torch.utils.weights import from_jax
from test_torch_port_model import FLAGSHIP, narrow_flagship, port_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), f"keys differ at {path or '/'}"
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


@pytest.mark.parametrize("which", ["narrowed", "flagship"])
def test_weight_bridge_round_trip(which):
    """convert_ctc(from_jax(v)) == v leaf for leaf, and from_jax inverts
    convert_ctc on the port's own state_dict, which the port then loads."""
    if which == "narrowed":
        model = port_model(narrow_flagship())
    else:
        model = build_model(FLAGSHIP, "cpu", torch.float32, torch.Generator().manual_seed(3))
    sd = model.state_dict()
    params, stats = TC.convert_ctc(sd)
    variables = {"params": params, "batch_stats": stats}
    back = from_jax(variables)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape and back[k].dtype == v.dtype, k
        torch.testing.assert_close(back[k], v, rtol=0, atol=0, msg=k)
    params2, stats2 = TC.convert_ctc(back)
    assert_trees_equal({"params": params2, "batch_stats": stats2}, variables)
    model.load_state_dict(back, strict=True)


def test_weight_bridge_loads_into_a_fresh_model():
    src = port_model(narrow_flagship(), seed=4)
    params, stats = TC.convert_ctc(src.state_dict())
    dst = ModelCTC(narrow_flagship(), 32).eval()
    dst.load_state_dict(from_jax({"params": params, "batch_stats": stats}), strict=True)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 6000)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(dst(x, torch.tensor([6000]))[0],
                                   src(x, torch.tensor([6000]))[0], rtol=0, atol=0)


def test_port_runs_without_jax():
    code = textwrap.dedent(f"""
        import json, sys
        import torch
        from efficientconformer_torch.models.model_ctc import ModelCTC, greedy_decode, init_params_
        with open({FLAGSHIP!r}) as f:
            p = json.load(f)["encoder_params"]
        p.update(num_blocks=3, dim_model=[24, 36], num_heads=4, subsampling_filters=[8],
                 strided_blocks=[1], expand_blocks=[1])
        model = ModelCTC(p, 16)
        init_params_(model, torch.Generator().manual_seed(0))
        tokens, counts = greedy_decode(model.eval(), torch.randn(2, 8000), torch.tensor([8000, 5000]))
        loaded = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith(("jax.", "jaxlib", "flax",
                                                       "efficientconformer_tpu")))
        print("LOADED", loaded, tuple(tokens.shape))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED [] (2, 13)" in out.stdout, out.stdout


def run_chip_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_gpu():
    out = run_chip_smoke(REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = run_chip_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_wrapper_has_no_path_for_other_devices():
    args = [torch.empty(1, 2, 3, 4, device="meta")] * 3
    with pytest.raises(ValueError, match="no kernel for device"):
        RA.relpos_attention(*args, None, None, None, None, None, 1.0)
