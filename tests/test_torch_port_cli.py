"""The port's CLI, ``efficientconformer_torch.main``, in this process on
the CPU (``--cpu``), on tests/test_e2e.py's mini-LibriSpeech and tiny
models: training with validation and a checkpoint every epoch, a resumed
run equal to the uninterrupted one, greedy test evaluation against a direct
``evaluate``, SWA of both types against the averages of the checkpoints,
the eval_time modes, the Transducer from a frozen CTC encoder, the LM on a
text corpus, beam-search evaluation (CTC with the n-gram on the device and
on the host, the Transducer with the n-gram and a port LM checkpoint
fused, on the device and on the host) against direct calls of the beams,
``--profiler``'s table, and the flags the port refuses.
"""

import ast
import contextlib
import io
import json
import math
import re
import shutil

import pytest
import torch

from ngram_synth import synth_arpa
from test_e2e import SENTENCES
from test_torch_port_checkpoint import tiny_config
from test_torch_port_runtime import prepare

from efficientconformer_torch import main as cli
from efficientconformer_torch import runtime
from efficientconformer_torch.data import datasets
from efficientconformer_torch.data.loader import AsrBatchLoader
from efficientconformer_torch.decoding import ctc_beam, rnnt_beam
from efficientconformer_torch.decoding.ctc_beam_device import ctc_beam_search_device
from efficientconformer_torch.decoding.ngram import ArpaLM
from efficientconformer_torch.decoding.rnnt_beam_device import beam_search_device
from efficientconformer_torch.models.transducer import greedy_token_cap
from efficientconformer_torch.training import checkpoint
from efficientconformer_torch.training.trainer import Trainer


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the tiny models here: the test workers share
    the machine's cores, and contended threads slow small ops many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(tmp dir, CTC config, Transducer config) over one prepared dataset."""
    tmp = tmp_path_factory.mktemp("cli")
    root = str(tmp / "LibriSpeech")
    cfg = tiny_config(tmp, root)
    prepare(root, cfg)
    return tmp, cfg, tiny_config(tmp, root, "Transducer")


def run_cli(cfg_path, *args):
    """``python -m efficientconformer_torch.main --cpu -c cfg_path *args``
    in this process; its standard output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["--cpu", "-c", cfg_path, *map(str, args)]) == 0
    return out.getvalue()


def write_config(cfg, path, callbacks):
    cfg = json.loads(json.dumps(cfg))
    cfg["training_params"]["callback_path"] = str(callbacks) + "/"
    with open(path, "w") as f:
        json.dump(cfg, f)
    return str(path)


def epochs_of(out):
    """(epoch, mean loss, steps) of each 'epoch k/K loss X (...)' line."""
    return [(int(e), float(x), int(n)) for e, x, n in
            re.findall(r"epoch (\d+)/\d+ loss (\S+) \([\d.]+s, (\d+) steps", out)]


def test_cli_trains_resumes_tests_and_averages(setup, tmp_path):
    _, cfg, _ = setup
    cb = tmp_path / "cb"
    path = write_config(cfg, tmp_path / "ctc.json", cb)
    common = ["--steps_per_epoch", 2, "--batch_size_eval", 3, "--num_workers", 2]
    out = run_cli(path, "-m", "training", "--val_steps", 1, *common)
    epochs = epochs_of(out)
    assert [e[0] for e in epochs] == [1, 2] and all(e[2] == 2 for e in epochs)
    assert all(math.isfinite(e[1]) for e in epochs)
    assert len(re.findall(r"val: \{'WER': [\d.]+, 'MeanLoss': [\d.]+\}", out)) == 2
    first, second = (checkpoint.read(str(cb / f"checkpoints_{e}.ckpt")) for e in (1, 2))
    assert first["step"] == 2 and second["step"] == 4 and second["optimizer"]["state"]

    # -i 1 runs epoch 2 again from epoch 1's checkpoint: the same checkpoint
    shutil.move(str(cb / "checkpoints_2.ckpt"), str(tmp_path / "uninterrupted.ckpt"))
    out = run_cli(path, "-m", "training", "-i", 1, "--val_steps", 1, *common)
    assert [e[0] for e in epochs_of(out)] == [2]
    again = checkpoint.read(str(cb / "checkpoints_2.ckpt"))
    want = checkpoint.read(str(tmp_path / "uninterrupted.ckpt"))
    assert again["step"] == want["step"] == 4
    for k, v in want["model"].items():
        assert torch.equal(again["model"][k], v), k

    # greedy test evaluation: the WER of a direct evaluate over the same data
    out = run_cli(path, "-m", "test-clean", "-i", 2, "--gready", *common)
    trainer = Trainer(cfg, device="cpu")
    trainer.load(str(cb / "checkpoints_2.ckpt"))
    ds = datasets.LibriSpeechDataset(cfg["training_params"]["evaluation_dataset_path"],
                                     "test-clean", vocab_size=48)
    w, truths, _, _ = runtime.evaluate(trainer, ds, runtime.load_tokenizer(cfg), batch_size=3)
    assert len(truths) == 4
    assert f"Greedy Search WER : {100 * w:.2f}%" in out

    # SWA over epochs 1-2, both types: parameters averaged, BatchNorm
    # statistics refreshed over the training data, no optimizer
    names = [n for n, _ in trainer.model.named_parameters()]
    for kind, avg in (("equal", checkpoint.swa_average),
                      ("exp", checkpoint.swa_exp_average)):
        run_cli(path, "-m", "training", "--swa", "--swa_type", kind, "--swa_epochs", 1, 2,
                "--steps_per_epoch", 2)
        swa = checkpoint.read(str(cb / f"checkpoints_swa-{kind}-1-2.ckpt"))
        want = avg([first, again], names)
        assert swa["optimizer"] is None and swa["step"] == 4
        for k, v in want["model"].items():
            if k in names:
                assert torch.equal(swa["model"][k], v), k
            elif "running" in k:
                assert not torch.equal(swa["model"][k], v), k

    for mode in ("eval_time", "eval_time_encoder"):
        out = run_cli(path, "-m", mode, "-i", 2, "--batch_size_eval", 3, "--val_steps", 1)
        assert re.search(r"eval time : [\d.]+s", out), out
    with pytest.raises(ValueError, match="Transducer"):
        run_cli(path, "-m", "eval_time_decoder", "--batch_size_eval", 3)


def test_cli_transducer(setup, tmp_path):
    """Training from a CTC checkpoint's encoder (--initial_epoch_encoder),
    frozen for the 2 steps (encoder_frozen_steps), with variational noise
    from step 1; greedy test; eval_time_decoder."""
    _, ctc_cfg, cfg = setup
    ctc = Trainer(ctc_cfg, device="cpu", seed=6)
    ctc.save(str(tmp_path / "enc" / "checkpoints_7.ckpt"))
    cfg = json.loads(json.dumps(cfg))
    cfg["training_params"].update(epochs=1, vn_start_step=1, vn_std=0.05,
                                  encoder_frozen_steps=2,
                                  callback_path_encoder=str(tmp_path / "enc"))
    path = write_config(cfg, tmp_path / "rnnt.json", tmp_path / "cb")
    out = run_cli(path, "-m", "eval_time_encoder", "--initial_epoch_encoder", 7,
                  "--batch_size_eval", 2, "--val_steps", 1)
    assert re.search(r"eval time : [\d.]+s", out)
    out = run_cli(path, "-m", "training", "--steps_per_epoch", 2, "--val_steps", 1,
                  "--batch_size_eval", 2, "--initial_epoch_encoder", 7)
    (_, loss, steps), = epochs_of(out)
    assert steps == 2 and math.isfinite(loss)
    trained = checkpoint.read(str(tmp_path / "cb" / "checkpoints_1.ckpt"))
    assert trained["step"] == 2
    encoder = [n for n, _ in ctc.model.named_parameters() if n.startswith("encoder.")]
    assert encoder and all(torch.equal(trained["model"][n], ctc.model.state_dict()[n])
                           for n in encoder)
    out = run_cli(path, "-m", "test-clean", "-i", 1, "--gready", "--batch_size_eval", 2,
                  "--rnnt_max_consec_dec_steps", 2)
    assert re.search(r"Greedy Search WER : [\d.]+%", out)
    out = run_cli(path, "-m", "eval_time_decoder", "-i", 1, "--batch_size_eval", 2)
    assert re.search(r"eval time : [\d.]+s", out)


def test_cli_lm(setup, tmp_path):
    """A tiny LM-Transformer trains on a text corpus and is scored on the
    dev transcripts (lm_mode)."""
    _, ctc_cfg, _ = setup
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(SENTENCES * 4) + "\n")
    tp = ctc_cfg["training_params"]
    cfg = {
        "model_name": "Tiny LM", "model_type": "LM",
        "lm_params": {"arch": "Transformer", "num_blocks": 2, "dim_model": 16, "ff_ratio": 2,
                      "num_heads": 2, "vocab_size": 48, "relative_pos_enc": True,
                      "max_pos_encoding": 64, "Pdrop": 0.1},
        "tokenizer_params": ctc_cfg["tokenizer_params"],
        "training_params": {
            "epochs": 1, "batch_size": 4, "accumulated_steps": 2, "mixed_precision": False,
            "optimizer": "Adam", "beta1": 0.9, "beta2": 0.95, "eps": 1e-8,
            "weight_decay": 0.0, "lr_schedule": "Constant", "lr_value": 1e-3,
            "train_label_max_length": 24, "eval_audio_max_length": None,
            "eval_label_max_length": None, "training_dataset": "LibriSpeechCorpus",
            "training_dataset_path": str(corpus), "evaluation_dataset": "LibriSpeech",
            "evaluation_dataset_path": tp["evaluation_dataset_path"], "lm_mode": True},
        "decoding_params": {"beam_size": 16, "tmp": 1},
    }
    path = write_config(cfg, tmp_path / "lm.json", tmp_path / "cb")
    out = run_cli(path, "-m", "training", "--batch_size_eval", 2)
    (_, loss, steps), = epochs_of(out)
    assert steps == 4 and math.isfinite(loss)
    assert re.search(r"val: \{'MeanLoss': [\d.]+\}", out)
    out = run_cli(path, "-m", "validation-clean", "-i", 1, "--batch_size_eval", 2)
    loss, ppl = map(float, re.search(r"Eval Loss : (\S+) \| Perplexity : (\S+)", out).groups())
    assert math.isfinite(loss) and ppl == pytest.approx(math.exp(loss), rel=1e-2)


@pytest.mark.parametrize("flags,item", [
    (["--gready", "--model_parallel", 2], "item 14"),
    (["--gready", "--seq_parallel", 2], "item 14"),
    (["--gready", "-d"], "item 14"),
    (["--gready", "--parallel"], "item 14"),
    (["--gready", "--world_size", 2], "item 14"),
])
def test_cli_refuses_what_it_lacks(setup, tmp_path, flags, item):
    """Parallelism raises, naming its ROADMAP item."""
    _, cfg, _ = setup
    cfg = json.loads(json.dumps(cfg))
    cfg["decoding_params"]["beam_size"] = 16
    path = write_config(cfg, tmp_path / "ctc.json", tmp_path / "cb")
    with pytest.raises(NotImplementedError, match=item):
        run_cli(path, "-m", "test-clean", "--batch_size_eval", 3, *flags)


@pytest.mark.parametrize("model,mode", [("ctc", "eval_time_encoder"),
                                        ("transducer", "eval_time_decoder")])
def test_cli_profiler_prints_the_op_table(setup, tmp_path, model, mode):
    """--profiler: the top-10 table of the timed work (ops by self CPU time
    on the CPU), printed before the eval time line, and the trace under
    callback_path/profile/."""
    _, ctc_cfg, t_cfg = setup
    cfg = ctc_cfg if model == "ctc" else t_cfg
    path = write_config(cfg, tmp_path / f"{model}.json", tmp_path / "cb")
    out = run_cli(path, "-m", mode, "--batch_size_eval", 3, "--val_steps", 1, "--profiler")
    head = re.search(r"profiler: top (\d+) ops by self CPU time \((.*)\):\n", out)
    assert head and head.group(2) == str(tmp_path / "cb" / "profile"), out
    table, rest = out[head.end():].split("\neval time : ")
    rows = table.splitlines()[2:]
    assert len(rows) == int(head.group(1)) == 10 and re.match(r"[\d.]+s", rest)
    totals = [float(row.split()[-4].removesuffix("ms")) for row in rows]
    assert totals == sorted(totals, reverse=True) and totals[0] > 0
    assert (tmp_path / "cb" / "profile" / "trace.json").stat().st_size > 0


def beam_config(cfg, tmp_path, lm_callbacks=None):
    """``cfg`` with the shipped configs' decoding_params at beam 4: a
    synthetic 3-gram over its 48 tokens (alpha 0.3, beta 1) and, with
    ``lm_callbacks``, a tiny LM-Transformer config whose checkpoints lie
    there (lm_weight 0.5)."""
    cfg = json.loads(json.dumps(cfg))
    arpa = str(tmp_path / "lm3.arpa")
    synth_arpa(arpa, vocab=48, order=3, counts=(0, 120, 200), seed=4)
    dp = {"beam_size": 4, "tmp": 1, "ngram_path": arpa, "ngram_alpha": 0.3, "ngram_beta": 1,
          "lm_weight": 0.5, "lm_tmp": 1}
    if lm_callbacks is not None:
        lm_cfg = {"model_name": "Tiny LM", "model_type": "LM",
                  "lm_params": {"arch": "Transformer", "num_blocks": 2, "dim_model": 16,
                                "ff_ratio": 2, "num_heads": 2, "vocab_size": 48,
                                "relative_pos_enc": True, "max_pos_encoding": 64, "Pdrop": 0.1},
                  "tokenizer_params": cfg["tokenizer_params"],
                  "training_params": {"optimizer": "Adam", "beta1": 0.9, "beta2": 0.95,
                                      "eps": 1e-8, "weight_decay": 0.0,
                                      "lr_schedule": "Constant", "lr_value": 1e-3,
                                      "mixed_precision": False},
                  "decoding_params": {"beam_size": 4, "tmp": 1}}
        dp["lm_config"] = write_config(lm_cfg, tmp_path / "lm.json", lm_callbacks)
    cfg["decoding_params"] = dp
    return cfg


def predictions(out):
    """Every batch's predictions that --verbose_val printed, in order."""
    return [p for block in re.findall(r"Predictions:\n (\[.*?\])\n", out)
            for p in ast.literal_eval(block)]


def direct_beam(cfg, beam, batch_size=2):
    """``beam(trainer, audio, audio_len)`` -> token lists over the
    test-clean batches that evaluate() decodes, with the weights the CLI
    draws (seed 0): the predictions as strings."""
    trainer = Trainer(cfg, device="cpu")
    ds = datasets.LibriSpeechDataset(cfg["training_params"]["evaluation_dataset_path"],
                                     "test-clean", vocab_size=48)
    tokenizer = runtime.load_tokenizer(cfg)
    preds = []
    for batch in AsrBatchLoader(ds, batch_size, shuffle=False, drop_last=False).epoch(0):
        mb = {k: torch.as_tensor(v).reshape((-1,) + v.shape[2:]) for k, v in batch.items()
              if k != "n_valid"}
        with torch.inference_mode():
            preds += tokenizer.decode(beam(trainer.model.eval(), mb["audio"], mb["audio_len"]))
    return preds


def test_cli_ctc_beam_search(setup, tmp_path, monkeypatch):
    """test-clean without --gready: the device prefix beam with the n-gram;
    with ECF_HOST_BEAM=1 the host C++ beam. Each prints its Beam Search WER
    and predictions equal to the beam called directly."""
    _, cfg, _ = setup
    cfg = beam_config(cfg, tmp_path)
    path = write_config(cfg, tmp_path / "ctc.json", tmp_path / "cb")
    dp = cfg["decoding_params"]
    arpa = ArpaLM(dp["ngram_path"])

    def device(model, x, x_len):
        logits, n = model(x, x_len)
        return ctc_beam_search_device(logits.float().log_softmax(-1), n, 4, ngram=arpa,
                                      alpha=0.3, beta=1)

    def host(model, x, x_len):
        logits, n = model(x, x_len)
        return ctc_beam.beam_search_batch(logits.float().log_softmax(-1).numpy(), n.numpy(), 4,
                                          lm_path=dp["ngram_path"], alpha=0.3, beta=1)

    for env, beam in ((None, device), ("1", host)):
        if env:
            monkeypatch.setenv("ECF_HOST_BEAM", env)
        out = run_cli(path, "-m", "test-clean", "--batch_size_eval", 2, "--verbose_val")
        assert re.search(r"Beam Search WER : [\d.]+%", out)
        got = predictions(out)
        assert len(got) == 4 and got == direct_beam(cfg, beam)


def test_cli_transducer_beam_search_with_lm_fusion(setup, tmp_path, monkeypatch):
    """test-clean without --gready for the Transducer: the device beam with
    the n-gram, and with --initial_epoch_lm 1 also the LM of lm_config from
    a port checkpoint; then with ECF_HOST_BEAM=1 the host beams, the batched
    one with the n-gram alone and the per-utterance one with the
    Transformer LM as well: each prints its predictions equal to the beam
    called directly."""
    _, _, cfg = setup
    lm_cb = tmp_path / "lm_cb"
    cfg = beam_config(cfg, tmp_path, lm_callbacks=lm_cb)
    path = write_config(cfg, tmp_path / "rnnt.json", tmp_path / "cb")
    lm_trainer = Trainer(cfg["decoding_params"]["lm_config"], device="cpu", seed=3)
    lm_trainer.save(str(lm_cb / "checkpoints_1.ckpt"))
    lm_model = lm_trainer.model.eval()
    arpa = ArpaLM(cfg["decoding_params"]["ngram_path"])

    def beam(model, x, x_len, **fusion):
        cap = greedy_token_cap(cfg["encoder_params"], x.shape[1], 5)
        return beam_search_device(model, x, x_len, beam_size=4, max_tokens=cap, ngram=arpa,
                                  ngram_alpha=0.3, ngram_beta=1, **fusion)

    for flags, fusion in (([], {}), (["--initial_epoch_lm", 1],
                                     {"lm_model": lm_model, "lm_weight": 0.5})):
        out = run_cli(path, "-m", "test-clean", "--batch_size_eval", 2, "--verbose_val", *flags)
        assert re.search(r"Beam Search WER : [\d.]+%", out)
        got = predictions(out)
        assert len(got) == 4 and got == direct_beam(
            cfg, lambda m, x, n, f=fusion: beam(m, x, n, **f))
    monkeypatch.setenv("ECF_HOST_BEAM", "1")
    ng = dict(beam_size=4, ngram=arpa, ngram_alpha=0.3, ngram_beta=1)
    for flags, fn, fusion in (([], rnnt_beam.beam_search_batched, {}),
                              (["--initial_epoch_lm", 1], rnnt_beam.beam_search,
                               {"lm_model": lm_model, "lm_weight": 0.5})):
        out = run_cli(path, "-m", "test-clean", "--batch_size_eval", 2, "--verbose_val", *flags)
        assert re.search(r"Beam Search WER : [\d.]+%", out)
        got = predictions(out)
        assert len(got) == 4 and got == direct_beam(
            cfg, lambda m, x, n, fn=fn, f=fusion: fn(m, x, n, **ng, **f))
