"""CTC model and greedy decoding.

Counterpart of efficientconformer_tpu/models/model_ctc.py: ModelCTC =
ConformerEncoder + vocabulary projection; greedy decoding is argmax ->
repeat/blank collapse -> left-compaction, batched on the device. With
``interctc_blocks`` it is the InterCTC model: the encoder's taps
(models/encoders.py) return their probabilities beside the logits, for the
loss (models/factory.py); decoding reads the logits only.
"""

from __future__ import annotations

import torch
from torch import nn

from efficientconformer_torch.config import load_config
from efficientconformer_torch.models.attentions import MultiHeadSelfAttention
from efficientconformer_torch.models.encoders import ConformerEncoder
from efficientconformer_torch.models.layers import Linear, init_weights_


class ModelCTC(nn.Module):
    """``interctc_blocks`` None builds the CTC model; a sequence of block
    indices, empty too, the InterCTC model."""

    def __init__(self, encoder_params: dict, vocab_size: int, interctc_blocks=None):
        super().__init__()
        self.interctc = interctc_blocks is not None
        self.encoder = ConformerEncoder(encoder_params, vocab_size, interctc_blocks or ())
        d = encoder_params["dim_model"]
        self.fc = Linear(d[-1] if isinstance(d, list) else d, vocab_size)

    def forward(self, x, x_len, generator=None):
        """(B, T_audio) -> (logits (B, T, V), logits_len (B,)), and for the
        InterCTC model also its taps' probabilities, a list of (B, T_i, V),
        empty without taps (model_ctc.py:34-37). ``generator`` feeds
        SpecAugment and dropout in training mode."""
        enc, enc_len, probs = self.encoder.forward_taps(x, x_len, generator)
        if self.interctc:
            return self.fc(enc), enc_len, probs
        return self.fc(enc), enc_len


def build_model(config_path: str, device, dtype: torch.dtype,
                generator: torch.Generator) -> ModelCTC:
    """ModelCTC of a CTC config, in eval mode on ``device``, computing in
    ``dtype`` after the fp32 frontend. Weights are fp32 and drawn from
    ``generator`` (a CPU generator) with the torch-default distributions."""
    cfg = load_config(config_path)
    if cfg["model_type"] != "CTC":
        raise ValueError(f"{config_path} is a {cfg['model_type']} config (a Transducer's "
                         "build_model is in models/transducer.py)")
    enc_params = dict(cfg["encoder_params"])
    if dtype != torch.float32:
        enc_params["compute_dtype"] = str(dtype).removeprefix("torch.")
    model = ModelCTC(enc_params, cfg["tokenizer_params"]["vocab_size"])
    init_params_(model, generator)
    return model.to(device).eval()


def init_params_(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every Linear/Conv/Embedding/LSTM parameter and the rel-pos
    biases u, v from ``generator``, in module order."""
    init_weights_(model, generator)
    for m in model.modules():
        if isinstance(m, MultiHeadSelfAttention):
            m.init_rel_biases_(generator)


def ctc_greedy_collapse(preds: torch.Tensor, pred_len: torch.Tensor, blank: int = 0):
    """Collapse framewise argmax ids: remove repeats, then blanks, batched.
    preds (B, T) int, pred_len (B,) -> (tokens (B, T) 0-padded, n_tokens (B,))."""
    b, t = preds.shape
    prev = torch.cat([torch.full_like(preds[:, :1], -1), preds[:, :-1]], dim=1)
    valid = torch.arange(t, device=preds.device)[None, :] < pred_len[:, None]
    keep = (preds != blank) & (preds != prev) & valid
    pos = torch.where(keep, torch.cumsum(keep, dim=1) - 1, t)
    buf = torch.zeros((b, t + 1), dtype=preds.dtype, device=preds.device)
    buf.scatter_(1, pos, preds)       # dropped frames all land in column t
    return buf[:, :t], keep.sum(dim=1)


@torch.inference_mode()
def greedy_decode(model: ModelCTC, x: torch.Tensor, x_len: torch.Tensor):
    """Greedy CTC decode: (token ids (B, T), counts (B,))."""
    logits, logits_len = model(x, x_len)[:2]
    return ctc_greedy_collapse(logits.argmax(dim=-1), logits_len)
