"""Import a checkpoint of the original PyTorch repo into the port's format.

    python -m efficientconformer_torch.import_checkpoint \
        --config_file configs/EfficientConformerCTCSmall.json \
        --torch_ckpt checkpoints_swa-equal-401-450.ckpt \
        --out callbacks/EfficientConformerCTCSmall/checkpoints_450.ckpt --with-tokenizer

The original saves ``{"model_state_dict", "optimizer_state_dict",
"model_step", "tokenizer", "is_distributed"}`` with torch.save (reference
models/model.py:346-384). The port's modules keep the original's names and
layouts (utils/weights.py), so its ``model_state_dict`` loads into the port
model of ``--config_file`` strictly, after two maps of what the port names
otherwise:
  * the ``module.`` prefix of a model saved under DistributedDataParallel
    is dropped (reference model.py:372-377);
  * the frontend's buffers under ``encoder.preprocessing.`` (torchaudio's
    STFT window and mel filterbank, fixed by the config) are dropped: the
    port derives them from the config (ops/audio.py) and keeps none.
Everything else, the BatchNorm buffers (``num_batches_tracked`` too) and
InterCTC's taps (``encoder.linear_expand_{i}``, ``encoder.linear_proj_{i}``)
included, carries the same name on both sides; a missing or unexpected
entry raises. The subsampling's input projection keeps the original's
channel-major flatten, so it is copied as it is (the JAX package's
importer permutes it, utils/torch_compat._permute_linear_in).

It writes a port checkpoint ``{"model", "optimizer", "step"}``, the step the
file's ``model_step`` and the optimizer freshly built from the config (the
original's optimizer state is not carried over), which ``-i`` loads. With
``--with-tokenizer`` the pickled sentencepiece processor of the file's
``tokenizer`` entry is unpickled through utils/spm_shim.py (no sentencepiece
package needed) and its serialized ModelProto written to the config's
``tokenizer_path`` (or ``--tokenizer_out``), pairing the weights with the
exact vocabulary they were trained on (reference models/model.py:50).
Importing reads and writes files and computes nothing, so it runs on the
host whatever the device.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import torch

DROPPED_PREFIXES = ("encoder.preprocessing.",)


def original_state_dict(ckpt: dict) -> dict:
    """The model entries of an original checkpoint under the port's names."""
    sd = ckpt["model_state_dict"] if "model_state_dict" in ckpt else ckpt
    out = {}
    for key, value in sd.items():
        key = key.removeprefix("module.")
        if not key.startswith(DROPPED_PREFIXES):
            out[key] = value
    return out


def import_checkpoint(config_file: str, torch_ckpt: str, out: str, with_tokenizer: bool = False,
                      tokenizer_out: Optional[str] = None) -> dict:
    """Convert ``torch_ckpt`` for the model of ``config_file`` into the port
    checkpoint ``out`` (and its tokenizer, asked for); returns what was
    written: {"parameters", "step", "tokenizer" (path or None), "pieces"}."""
    from efficientconformer_torch.config import load_config
    from efficientconformer_torch.data.tokenizer import BpeTokenizer
    from efficientconformer_torch.training.trainer import Trainer
    from efficientconformer_torch.utils import spm_shim

    spm_shim.install()      # lets torch.load unpickle the tokenizer entry
    config = load_config(config_file)
    ckpt = torch.load(torch_ckpt, map_location="cpu", weights_only=False)
    trainer = Trainer(config, device="cpu")
    trainer.model.load_state_dict(original_state_dict(ckpt), strict=True)
    trainer.step = int(ckpt.get("model_step", 0))
    trainer.save(out)
    done = {"parameters": sum(p.numel() for p in trainer.model.parameters()),
            "step": trainer.step, "tokenizer": None, "pieces": None}
    if with_tokenizer:
        entry = ckpt.get("tokenizer")
        if entry is None:
            raise KeyError(f"{torch_ckpt} carries no tokenizer entry")
        path = tokenizer_out or config["tokenizer_params"]["tokenizer_path"]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            f.write(entry.serialized_model_proto())
        pieces = BpeTokenizer.load(path).vocab_size()
        want = config["tokenizer_params"]["vocab_size"]
        if pieces != want:
            raise ValueError(f"the extracted tokenizer has {pieces} pieces, the config "
                             f"{want}")
        done.update(tokenizer=path, pieces=pieces)
    return done


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config_file", required=True)
    p.add_argument("--torch_ckpt", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--with-tokenizer", action="store_true",
                   help="extract the pickled sentencepiece tokenizer and write it to the "
                        "config's tokenizer_path")
    p.add_argument("--tokenizer_out", default=None,
                   help="override output path for the extracted .model")
    args = p.parse_args(argv)
    done = import_checkpoint(args.config_file, args.torch_ckpt, args.out, args.with_tokenizer,
                             args.tokenizer_out)
    print(f"imported {done['parameters']} parameters (step {done['step']}) -> {args.out}")
    if done["tokenizer"]:
        print(f"extracted tokenizer ({done['pieces']} pieces) -> {done['tokenizer']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
