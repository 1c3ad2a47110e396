"""Neural language model: a decoder and the vocabulary projection.

Counterpart of efficientconformer_tpu/models/lm.py: ``LanguageModel`` runs
the teacher-forced pass (a blank prepended to the tokens, logits for every
position) over the RNN decoder (LM-RNN) or the causal rel-pos Transformer
decoder (LM-Transformer), and ``ce_loss`` is its cross entropy. Users score
an LM with its eval loss and perplexity (runtime.py:241-260, 549-558),
train it with ``training/trainer.py``, and fuse it into the Transducer beams
through the single-token ``step``: the device beam
(decoding/rnnt_beam_device.py) on a fixed-shape carry (``init_carry_fixed``:
the RNN's state, or the Transformer's fixed-capacity KV cache), the host
beams (decoding/rnnt_beam.py) on ``init_carry`` (the RNN's state, or None:
the Transformer's growing KV cache), lm.py:35-50.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from efficientconformer_torch.config import default_device, load_config
from efficientconformer_torch.models.decoders import make_decoder
from efficientconformer_torch.models.layers import Linear
from efficientconformer_torch.models.model_ctc import init_params_


class LanguageModel(nn.Module):
    def __init__(self, lm_params: dict, vocab_size: int):
        super().__init__()
        self.decoder = make_decoder(lm_params)
        self.fc = Linear(lm_params["dim_model"], vocab_size)

    def forward(self, x: torch.Tensor, x_len: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Tokens x (B, U) 0-padded, lengths x_len (B,) or None -> logits
        (B, U+1, V), a blank prepended (lm.py:25-33). ``generator`` feeds
        dropout in training mode."""
        x = F.pad(x, (1, 0))
        if x_len is not None:
            x_len = x_len + 1
        return self.fc(self.decoder(x, x_len, generator))

    def step(self, y_t: torch.Tensor, carry):
        """One decode step: tokens (B,) -> (logits (B, V), new carry)."""
        h, carry = self.decoder.step(y_t, carry)
        return self.fc(h), carry

    def init_carry(self, batch: int, device):
        """The RNN's zero state; None (a growing cache) for a Transformer."""
        if hasattr(self.decoder, "init_carry"):
            return self.decoder.init_carry(batch, device)
        return None

    def init_carry_fixed(self, batch: int, max_len: int, device):
        """A fixed-shape carry for the beam's slots: the RNN's state, or a
        Transformer's KV cache of ``max_len`` slots."""
        if hasattr(self.decoder, "init_carry_fixed"):
            return self.decoder.init_carry_fixed(batch, max_len, device)
        return self.init_carry(batch, device)


def ce_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Cross entropy of fp32 log-softmaxed logits, positions with target -1
    ignored, the mean over the rest (lm.py:53-61)."""
    valid = targets >= 0
    lp = F.log_softmax(logits.to(torch.float32), dim=-1)
    lp = lp.gather(-1, torch.where(valid, targets, 0).long()[..., None])[..., 0]
    return -(lp * valid).sum() / valid.sum().clamp(min=1)


def build_model(config_path: str, device=None, dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None) -> LanguageModel:
    """LanguageModel of an LM config, in eval mode on ``device`` (the card
    unless the caller names one), computing in ``dtype`` after the
    embedding. Weights are fp32 and drawn from ``generator`` (a CPU
    generator, seed 0 by default)."""
    device = torch.device(device) if device is not None else default_device()
    cfg = load_config(config_path)
    if cfg["model_type"] != "LM":
        raise ValueError(f"{config_path} is a {cfg['model_type']} config")
    params = dict(cfg["lm_params"])
    if dtype != torch.float32:
        params["compute_dtype"] = str(dtype).removeprefix("torch.")
    model = LanguageModel(params, cfg["tokenizer_params"]["vocab_size"])
    init_params_(model, generator if generator is not None else torch.Generator().manual_seed(0))
    return model.to(device).eval()
