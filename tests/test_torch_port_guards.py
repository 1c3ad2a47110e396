"""Guards of the PyTorch port: the weight bridge round trip, that the port
and its CLI run without JAX, that its entry points default to the card and
never fall back to the CPU, and that chip_smoke.py has no CPU fallback."""

import math
import os
import re
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from efficientconformer_tpu.utils import torch_compat as TC
from efficientconformer_torch.models.model_ctc import ModelCTC, build_model
from efficientconformer_torch.ops import bias_attention as BA
from efficientconformer_torch.ops import rel_attention as RA
from efficientconformer_torch.utils.weights import from_jax
from test_torch_port_model import FLAGSHIP, narrow_flagship, port_model

TRANSDUCER = "configs/EfficientConformerTransducerSmall.json"
LM_TRANSFORMER = "configs/LM-Transformer.json"

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


def test_port_runs_without_jax(tmp_path):
    """Greedy decoding and one train step of the port, CTC and Transducer,
    both device beams with an n-gram (and the Transducer's with an
    LM-Transformer) fused in, a causal encoder streamed through a session
    and served through the slot-pool server, a tensor-parallel step over two
    gloo ranks (parallel/tensor.py) and a sequence-parallel one
    (parallel/sequence.py), in a fresh process load no module of JAX, flax
    or the JAX package."""
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

        # both device beams, the n-gram fused, the Transducer's with an
        # LM-Transformer too
        sys.path.insert(0, "tests")
        from ngram_synth import synth_arpa
        from efficientconformer_torch.decoding.ctc_beam_device import ctc_beam_search_device
        from efficientconformer_torch.decoding.ngram import ArpaLM
        from efficientconformer_torch.decoding.rnnt_beam_device import beam_search_device
        from efficientconformer_torch.models.lm import LanguageModel
        synth_arpa(sys.argv[1], vocab=16, order=3, counts=(0, 30, 40))
        arpa = ArpaLM(sys.argv[1])
        x, x_len = torch.randn(2, 8000), torch.tensor([8000, 5000])
        with torch.no_grad():
            logits, n = model.eval()(x, x_len)
        ctc = ctc_beam_search_device(logits.log_softmax(-1), n, 4, ngram=arpa, alpha=0.3, beta=1)
        lm = LanguageModel({{"arch": "Transformer", "num_blocks": 2, "dim_model": 16,
                             "ff_ratio": 2, "num_heads": 2, "vocab_size": 16,
                             "relative_pos_enc": True, "max_pos_encoding": 64,
                             "Pdrop": 0.0}}, 16)
        init_params_(lm, torch.Generator().manual_seed(1))
        rnnt = beam_search_device(tmodel.eval(), x, x_len, beam_size=4, max_tokens=cap,
                                  lm_model=lm.eval(), lm_weight=0.5, ngram=arpa,
                                  ngram_alpha=0.3, ngram_beta=1)
        # streaming and serving a causal, limited-context encoder
        from efficientconformer_torch import serving, streaming
        cp = dict(p, causal=True, left_context=8)
        causal = ModelCTC(cp, 16)
        init_params_(causal, torch.Generator().manual_seed(0))
        causal.eval()
        session = streaming.StreamingCTC(streaming.StreamingEncoderSession(
            causal, cp, chunk_frames=4, history_frames=8, device="cpu"))
        session.push(torch.randn(1, 12000).numpy())
        streamed = session.finish()
        srv = serving.StreamingServer(causal, cp, num_slots=2, chunk_frames=4,
                                      history_frames=8, device="cpu")
        srv.submit("a"); srv.push("a", torch.randn(9000).numpy()); srv.end("a")
        served = srv.drain()
        # a tensor-parallel step: two gloo ranks in one model group
        import copy
        from efficientconformer_torch import dryrun
        from efficientconformer_torch.parallel import mesh
        tp_cfg = copy.deepcopy(cfg)
        tp_cfg["training_params"]["model_parallel"] = 2
        ranks = mesh.launch(dryrun.shard_step, 2, (tp_cfg, batch), device_type="cpu",
                            threads=1, timeout=240)
        assert ranks[0]["loss"] == ranks[1]["loss"] and ranks[0]["model_size"] == 2
        assert ranks[0]["tp_calls"]["all_gather"] > 0 and ranks[0]["replicated"]
        # a sequence-parallel step: two gloo ranks in one seq group
        sp_cfg = copy.deepcopy(cfg)
        sp_cfg["training_params"]["seq_parallel"] = 2
        sp_ranks = mesh.launch(dryrun.shard_step, 2, (sp_cfg, batch), device_type="cpu",
                               threads=1, timeout=240)
        assert sp_ranks[0]["loss"] == sp_ranks[1]["loss"] and sp_ranks[0]["seq_size"] == 2
        assert sp_ranks[0]["sp_calls"]["halo"] > 0
        loaded = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith(("jax.", "jaxlib", "flax",
                                                       "efficientconformer_tpu")))
        print("LOADED", loaded, tuple(tokens.shape), tuple(ttokens.shape), len(ctc), len(rnnt),
              len(streamed), sorted(served), "TP", len(ranks), "SP", len(sp_ranks))
    """)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "lm3.arpa")], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED [] (2, 13) (2, 96) 2 2 1 ['a'] TP 2 SP 2" in out.stdout, out.stdout


def test_streaming_and_serving_need_a_card_or_the_cpu(monkeypatch):
    """Without a card the session and the server raise rather than move to
    the CPU; asked for the CPU, they run there."""
    from efficientconformer_torch import serving, streaming

    p = narrow_flagship()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        streaming.StreamingEncoderSession(None, p, history_frames=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.StreamingServer(None, p, history_frames=8)
    sess = streaming.StreamingEncoderSession(None, p, history_frames=8, device="cpu")
    srv = serving.StreamingServer(None, p, history_frames=8, device="cpu")
    assert sess.device.type == srv.device.type == "cpu"
    assert srv._buf.device.type == "cpu"


def test_lm_runs_without_jax():
    """Scoring and one train step of a narrowed LM-Transformer, and the
    LM-RNN's logits, in a fresh process load no module of JAX, flax or the
    JAX package."""
    code = textwrap.dedent(f"""
        import json, sys
        import torch
        from efficientconformer_torch.models import lm
        from efficientconformer_torch.training.trainer import Trainer
        with open({LM_TRANSFORMER!r}) as f:
            cfg = json.load(f)
        cfg["lm_params"].update(num_blocks=2, dim_model=32, num_heads=2, vocab_size=16)
        cfg["tokenizer_params"]["vocab_size"] = 16
        tokens = torch.tensor([[[3, 4, 5], [6, 0, 0]]] * 2)
        batch = {{"tokens": tokens, "token_len": torch.tensor([[3, 1]] * 2),
                  "targets": torch.tensor([[[3, 4, 5, 0], [6, 0, -1, -1]]] * 2)}}
        trainer = Trainer(cfg, device="cpu")
        loss, grad_norm = trainer.train_step(batch)
        assert torch.isfinite(loss) and torch.isfinite(grad_norm)
        score = trainer.eval_loss({{k: v[0] for k, v in batch.items()}})
        rnn = lm.LanguageModel({{"arch": "RNN", "num_layers": 1, "dim_model": 8,
                                "vocab_size": 16}}, 16)
        logits = rnn(tokens[0], torch.tensor([3, 1]))
        loaded = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith(("jax.", "jaxlib", "flax",
                                                       "efficientconformer_tpu")))
        print("LOADED", loaded, tuple(logits.shape), bool(torch.isfinite(score)))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED [] (2, 4, 16) True" in out.stdout, out.stdout


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


def test_bias_probe_fails_without_a_gpu_and_loads_no_jax():
    """scripts/torch_bias_attention_probe.py, like chip_smoke.py, measures
    on a card only, and loads nothing of JAX or the JAX package."""
    code = textwrap.dedent("""
        import runpy, sys
        sys.argv = ["torch_bias_attention_probe.py", "probe"]
        try:
            runpy.run_path("scripts/torch_bias_attention_probe.py", run_name="__main__")
        except SystemExit as exit_:
            print("EXIT", exit_.code)
        print("LOADED", sorted(m for m in sys.modules if m == "jax" or m.startswith(
            ("jax.", "jaxlib", "flax", "efficientconformer_tpu"))))
    """)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert "EXIT torch_bias_attention_probe: no CUDA device" in out.stdout, out.stdout + out.stderr
    assert "LOADED []" in out.stdout, out.stdout


@pytest.mark.parametrize("script", ["torch_ddp_probe.py", "torch_dp_multigpu.py",
                                    "torch_tp_multigpu.py", "torch_sp_multigpu.py"])
def test_dp_scripts_fail_without_a_gpu_and_load_no_jax(script):
    """The data-, tensor- and sequence-parallel measurements measure on a
    card only, and load nothing of JAX or the JAX package."""
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.argv = [{script!r}]
        try:
            runpy.run_path("scripts/{script}", run_name="__main__")
        except SystemExit as exit_:
            print("EXIT", exit_.code)
        print("LOADED", sorted(m for m in sys.modules if m == "jax" or m.startswith(
            ("jax.", "jaxlib", "flax", "efficientconformer_tpu"))))
    """)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert f"EXIT {script.removesuffix('.py')}: no CUDA device" in out.stdout, \
        out.stdout + out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_wrapper_has_no_path_for_other_devices():
    args = [torch.empty(1, 2, 3, 4, device="meta")] * 3
    with pytest.raises(ValueError, match="no kernel for device"):
        RA.relpos_attention(*args, None, None, None, None, None, 1.0)
    with pytest.raises(ValueError, match="no kernel for device"):
        RA.relpos_attention_bwd(*args, None, None, None, None, None, args[0], args[0], None, 1.0)


def test_bias_attention_has_no_path_for_other_devices():
    q = torch.empty(1, 2, 3, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        BA.bias_attention(q, q, q, None, 1.0)
    with pytest.raises(ValueError, match="no kernel for device"):
        BA.bias_attention_bwd(q, q, q, None, q, q, None, 1.0)


def test_lm_defaults_to_the_card_and_raises_without_one(monkeypatch):
    """The LM's build_model and its Trainer never move to the CPU on their
    own."""
    from efficientconformer_torch.models import lm
    from efficientconformer_torch.training.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.build_model(LM_TRANSFORMER)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(LM_TRANSFORMER)
    with pytest.raises(ValueError, match="CTC config"):
        lm.build_model(FLAGSHIP, "cpu")


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


CLI_CODE = textwrap.dedent("""
    import json, os, sys
    import torch
    torch.set_num_threads(1)      # tiny models; the test workers share the cores
    sys.path.insert(0, "tests")
    from test_e2e import make_config, make_dataset
    from efficientconformer_torch.main import main

    tmp = sys.argv[1]
    root = os.path.join(tmp, "LibriSpeech")
    make_dataset(root)
    cfg = make_config(root, tmp)
    common = ["--cpu", "-c", cfg, "--batch_size_eval", "2"]
    main(common + ["-m", "training", "--create_tokenizer", "-p", "--steps_per_epoch", "2",
                   "--val_steps", "1"])
    main(common + ["-m", "test-clean", "-i", "1", "--gready"])
    main(common + ["-m", "training", "--swa", "--swa_epochs", "1", "2",
                   "--steps_per_epoch", "2"])
    main(common + ["-m", "eval_time", "-i", "2", "--val_steps", "1"])
    print("FILES", sorted(os.listdir(os.path.join(tmp, "callbacks"))))
    print("LOADED", sorted(m for m in sys.modules if m == "jax" or m.startswith(
        ("jax.", "jaxlib", "flax", "efficientconformer_tpu"))))
""")


def test_cli_runs_without_jax(tmp_path):
    """The port's CLI on the CPU (--cpu) through a user's workflow on the
    tiny config: tokenizer and dataset preparation, two epochs of training
    with validation and checkpoints, greedy test evaluation, SWA and
    eval_time, in a fresh process that loads no module of JAX, flax or the
    JAX package. Every epoch takes steps with a finite loss (a loader that
    yields no batch would print loss nan and 0 steps)."""
    out = subprocess.run([sys.executable, "-c", CLI_CODE, str(tmp_path)], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    epochs = re.findall(r"epoch (\d)/2 loss (\S+) \([\d.]+s, (\d+) steps", out.stdout)
    assert [e[0] for e in epochs] == ["1", "2"], out.stdout
    assert all(math.isfinite(float(x)) and int(n) >= 1 for _, x, n in epochs), epochs
    assert re.search(r"val: \{'WER': [\d.]+, 'MeanLoss': [\d.]+\}", out.stdout)
    assert re.search(r"Greedy Search WER : [\d.]+%", out.stdout)
    assert re.search(r"eval time : [\d.]+s", out.stdout)
    assert ("FILES ['checkpoints_1.ckpt', 'checkpoints_2.ckpt', "
            "'checkpoints_swa-equal-1-2.ckpt'") in out.stdout, out.stdout
    assert "LOADED []" in out.stdout, out.stdout


def test_cli_raises_without_a_gpu_unless_asked_for_the_cpu(tmp_path):
    """Without --cpu the CLI runs on the card, and without one it raises
    rather than moving to the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "efficientconformer_torch.main", "-c",
                          FLAGSHIP, "-m", "test-clean", "--gready"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "RuntimeError: no CUDA device" in out.stderr, out.stderr[-3000:]
    assert "Model Parameters" not in out.stdout
