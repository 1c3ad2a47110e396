"""Guards of the PyTorch port: the weight bridge round trip, that the port
runs without JAX, that its entry points default to the card and never fall
back to the CPU, and that chip_smoke.py has no CPU fallback."""

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

TRANSDUCER = "configs/EfficientConformerTransducerSmall.json"

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
    """Greedy decoding and one train step of the port, CTC and Transducer,
    in a fresh process load no module of JAX, flax or the JAX package."""
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
        from efficientconformer_torch.training.trainer import Trainer
        with open({FLAGSHIP!r}) as f:
            cfg = json.load(f)
        cfg["encoder_params"] = p
        cfg["tokenizer_params"]["vocab_size"] = 16
        batch = {{"audio": torch.randn(2, 2, 8000), "audio_len": torch.tensor([[8000, 5000]] * 2),
                  "labels": torch.tensor([[[3, 4], [5, 0]]] * 2),
                  "label_len": torch.tensor([[2, 1]] * 2)}}
        trainer = Trainer(cfg, device="cpu")
        loss, grad_norm = trainer.train_step(batch)
        assert torch.isfinite(loss) and torch.isfinite(grad_norm)

        from efficientconformer_torch.models import transducer as T
        with open({TRANSDUCER!r}) as f:
            tcfg = json.load(f)
        tcfg["encoder_params"] = p
        tcfg["decoder_params"].update(dim_model=16, vocab_size=16)
        tcfg["joint_params"].update(dim_model=12)
        tcfg["tokenizer_params"]["vocab_size"] = 16
        tmodel = T.Transducer(p, tcfg["decoder_params"], tcfg["joint_params"], 16)
        init_params_(tmodel, torch.Generator().manual_seed(0))
        cap = T.greedy_token_cap(p, 8000, 5)
        ttokens, tcounts = T.greedy_decode(tmodel.eval(), torch.randn(2, 8000),
                                           torch.tensor([8000, 5000]), cap)
        tcfg["training_params"].update(vn_start_step=0)
        trainer = Trainer(tcfg, device="cpu")
        loss, grad_norm = trainer.train_step(batch)
        assert torch.isfinite(loss) and torch.isfinite(grad_norm)
        loaded = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith(("jax.", "jaxlib", "flax",
                                                       "efficientconformer_tpu")))
        print("LOADED", loaded, tuple(tokens.shape), tuple(ttokens.shape))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED [] (2, 13) (2, 96)" in out.stdout, out.stdout


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
    with pytest.raises(ValueError, match="no kernel for device"):
        RA.relpos_attention_bwd(*args, None, None, None, None, None, args[0], args[0], None, 1.0)


def test_trainer_defaults_to_the_card_and_raises_without_one(monkeypatch):
    """The trainer never moves to the CPU on its own."""
    from efficientconformer_torch.training.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(FLAGSHIP)


def test_transducer_build_model_defaults_to_the_card_and_raises_without_one(monkeypatch):
    from efficientconformer_torch.models import transducer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transducer.build_model(TRANSDUCER)
    with pytest.raises(ValueError, match="CTC config"):
        transducer.build_model(FLAGSHIP, "cpu")
