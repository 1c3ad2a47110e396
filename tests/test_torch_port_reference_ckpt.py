"""Checkpoints of the original PyTorch repo into the port and into the JAX
package, on the CPU.

An original-style file is fabricated as tests/test_spm_interop.py:198 does:
``{"model_state_dict", "optimizer_state_dict", "model_step", "tokenizer",
"is_distributed"}``, its tokenizer a pickled sentencepiece processor (the
JAX package's shim), its state dict a seeded model under the original's
names with the frontend's torchaudio buffers (tests/torch_ref.py's faithful
stubs) and, for one case, the ``module.`` prefix of a DDP save. The port's
importer (``python -m efficientconformer_torch.import_checkpoint
--with-tokenizer``) and the JAX converter (utils/torch_compat.convert_ctc /
convert_transducer) each read it; their models' logits agree within 1e-4
(which also holds the port's channel-major input projection to JAX's
permuted one), and both extract the same ModelProto bytes. A stray entry
makes the port's strict load raise.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from efficientconformer_tpu.config import from_dict
from efficientconformer_tpu.data.tokenizer import train_bpe
from efficientconformer_tpu.models import factory as jax_factory
from efficientconformer_tpu.utils import spm_shim as jax_spm_shim
from efficientconformer_tpu.utils import torch_compat as TC
from efficientconformer_torch import import_checkpoint as importer
from efficientconformer_torch.models import factory
from efficientconformer_torch.training.trainer import Trainer
from test_spm_interop import CORPUS
from test_torch_port_model import FLAGSHIP, narrow_flagship, perturb_norms_
from test_torch_port_transducer import narrow_transducer
from torch_ref import _MelScale, _Spectrogram

LOGIT_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tokenizer():
    return train_bpe(iter(CORPUS), vocab_size=40)


def config(kind, vocab, tmp_path) -> dict:
    if kind == "transducer":
        cfg = narrow_transducer()
        cfg["decoder_params"]["vocab_size"] = vocab
    else:
        with open(FLAGSHIP) as f:
            cfg = json.load(f)
        cfg["encoder_params"] = narrow_flagship()
        if kind == "interctc":
            cfg["model_type"] = "InterCTC"
            cfg["encoder_params"]["interctc_blocks"] = [0, 2]
    cfg["tokenizer_params"].update(vocab_size=vocab, tokenizer_path=str(tmp_path / "bpe.model"))
    cfg["training_params"]["mixed_precision"] = False
    return cfg


def fabricate(cfg, tokenizer, path, ddp=False, extra=None):
    """An original-style checkpoint of a seeded model; its state dict."""
    model, _ = factory.create_model(cfg, "cpu", torch.Generator().manual_seed(3))
    perturb_norms_(model, 4)
    sd = dict(model.state_dict())
    p = cfg["encoder_params"]
    win = p["sample_rate"] * p["win_length_ms"] // 1000
    frontend = {"Spectrogram": _Spectrogram(p["n_fft"], win), "MelScale": _MelScale(
        p["n_mels"], p["sample_rate"], 0, 8000, p["n_fft"] // 2 + 1)}
    for name, module in frontend.items():
        for buf, value in module.state_dict().items():
            sd[f"encoder.preprocessing.{name}.{buf}"] = value
    sd.update(extra or {})
    if ddp:
        sd = {f"module.{k}": v for k, v in sd.items()}
    proc = jax_spm_shim.install().SentencePieceProcessor()
    proc.LoadFromSerializedProto(tokenizer.to_sentencepiece_bytes())
    optimizer = torch.optim.Adam(model.parameters())
    torch.save({"model_state_dict": sd, "optimizer_state_dict": optimizer.state_dict(),
                "model_step": 1234, "tokenizer": proc, "is_distributed": ddp}, path)
    return sd


def audio_batch(seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, 12000)) * 0.1).astype(np.float32)
    x[1, 9000:] = 0.0
    return x, np.array([12000, 9000], np.int32)


@pytest.mark.parametrize("kind", ["ctc", "interctc", "transducer"])
def test_original_checkpoint_imports_into_both_packages(kind, tokenizer, tmp_path):
    cfg = config(kind, tokenizer.vocab_size(), tmp_path)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    ckpt_path, out = str(tmp_path / "original.ckpt"), str(tmp_path / "cb" / "checkpoints_7.ckpt")
    sd = fabricate(cfg, tokenizer, ckpt_path, ddp=kind == "transducer")

    # the port: the importer's command line, then the checkpoint as -i loads it
    assert importer.main(["--config_file", str(cfg_path), "--torch_ckpt", ckpt_path,
                          "--out", out, "--with-tokenizer"]) == 0
    trainer = Trainer(cfg, device="cpu", seed=9)
    trainer.load(out)
    assert trainer.step == 1234
    port = trainer.model.eval()

    # the JAX package: its converter on the same file
    loaded = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    want_proto = loaded["tokenizer"].serialized_model_proto()
    with open(cfg["tokenizer_params"]["tokenizer_path"], "rb") as f:
        assert f.read() == want_proto
    convert = TC.convert_transducer if kind == "transducer" else TC.convert_ctc
    params, stats = convert(loaded["model_state_dict"])
    jm, _ = jax_factory.create_model(from_dict(cfg))
    variables = {"params": params, "batch_stats": stats}

    x, x_len = audio_batch()
    if kind == "transducer":
        y = np.array([[3, 5, 7], [9, 2, 0]], np.int32)
        y_len = np.array([3, 2], np.int32)
        want, want_len = jax.jit(lambda v: jm.apply(v, x, y, x_len, y_len, False))(variables)
        with torch.no_grad():
            got, got_len = port(*(torch.from_numpy(a) for a in (x, y, x_len, y_len)))
    else:
        want, want_len, want_taps = jax.jit(lambda v: jm.apply(v, x, x_len, False))(variables)
        with torch.no_grad():
            got, got_len, *taps = port(torch.from_numpy(x), torch.from_numpy(x_len))
        assert len(taps[0] if taps else []) == len(want_taps)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGIT_TOL)
    assert any(k.startswith("module.encoder.preprocessing.") or
               k.startswith("encoder.preprocessing.") for k in sd)


def test_stray_entry_refuses_the_import(tokenizer, tmp_path):
    cfg = config("ctc", tokenizer.vocab_size(), tmp_path)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    ckpt_path = str(tmp_path / "original.ckpt")
    fabricate(cfg, tokenizer, ckpt_path, extra={"encoder.blocks.0.extra": torch.zeros(3)})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        importer.main(["--config_file", str(cfg_path), "--torch_ckpt", ckpt_path,
                       "--out", str(tmp_path / "out.ckpt")])


def test_port_shim_unpickles_and_pickles_as_sentencepiece(tokenizer):
    """The port's own shim (installed where the JAX package's is not):
    LoadFromSerializedProto, encode as the tokenizer, and a pickle that
    names the public class path."""
    import pickle
    import sys

    from efficientconformer_torch.data.tokenizer import BpeTokenizer
    from efficientconformer_torch.utils import spm_shim

    saved = sys.modules.pop("sentencepiece", None)
    try:
        mod = spm_shim.install()
        assert mod.SentencePieceProcessor is spm_shim.SentencePieceProcessor
        proc = mod.SentencePieceProcessor()
        proc.LoadFromSerializedProto(tokenizer.to_sentencepiece_bytes())
        blob = pickle.dumps(proc)
        assert b"sentencepiece" in blob
        back = pickle.loads(blob)
        port_tok = BpeTokenizer.from_sentencepiece(tokenizer.to_sentencepiece_bytes())
        for line in CORPUS:
            assert back.encode(line) == port_tok.encode(line) == tokenizer.encode(line)
        assert back.serialized_model_proto() == proc.serialized_model_proto()
    finally:
        if saved is not None:
            sys.modules["sentencepiece"] = saved
        else:
            sys.modules.pop("sentencepiece", None)
