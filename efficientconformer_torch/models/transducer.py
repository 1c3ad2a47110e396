"""Transducer model and greedy decoding.

Counterpart of efficientconformer_tpu/models/transducer.py: encoder +
prediction network + joint. The training pass gives the full (B, T, U+1, V)
joint lattice for the RNN-T loss (ops/rnnt_loss.py). Greedy decoding runs
the JAX package's lock-stepped per-utterance state machine, batched on the
device: at (frame t, decoder output g) pred = argmax joint(f_t, g); a blank
or the consecutive-emission cap advances the frame, a token is appended and
advances the decoder. Two exact implementations of it, as in the JAX
package: "label" (label-looping, one iteration per emission: the joint of
one decoder state against all frames, blank runs skipped in one step) and
"frame" (one iteration per frame or emission). The JAX ``while_loop``
condition is a host check per iteration here.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from efficientconformer_torch.config import (
    default_device,
    encoder_output_frames,
    load_config,
)
from efficientconformer_torch.models.decoders import make_decoder
from efficientconformer_torch.models.encoders import ConformerEncoder
from efficientconformer_torch.models.joint_networks import JointNetwork
from efficientconformer_torch.models.model_ctc import init_params_


class Transducer(nn.Module):
    """``vn_std`` goes to the prediction and joint networks only, never to
    the encoder (transducer.py:36-46)."""

    def __init__(self, encoder_params: dict, decoder_params: dict, joint_params: dict,
                 vocab_size: int, vn_std: Optional[float] = None):
        super().__init__()
        self.encoder = ConformerEncoder(encoder_params)
        self.decoder = make_decoder(decoder_params, vn_std)
        d = encoder_params["dim_model"]
        self.joint_network = JointNetwork(d[-1] if isinstance(d, list) else d,
                                          decoder_params["dim_model"], vocab_size, joint_params,
                                          vn_std)

    def forward(self, x, y, x_len, y_len, generator=None):
        """Lattice pass: waveforms x (B, T_audio), labels y (B, U) 0-padded
        -> (logits (B, T, U+1, V), f_len). A blank is prepended to y
        (transducer.py:48-58). ``generator`` feeds SpecAugment and dropout
        in training mode."""
        f, f_len = self.encoder(x, x_len, generator)
        y_in = nn.functional.pad(y, (1, 0))
        g = self.decoder(y_in, y_len + 1)
        return self.joint_network(f, g), f_len


def build_model(config_path: str, device=None, dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None) -> Transducer:
    """Transducer of a Transducer config, in eval mode on ``device`` (the
    card unless the caller names one), computing in ``dtype`` after the fp32
    frontend (the encoder, and the decoder and joint on the lattice path;
    the decode steps stay fp32). Weights are fp32 and drawn from
    ``generator`` (a CPU generator, seed 0 by default)."""
    device = torch.device(device) if device is not None else default_device()
    cfg = load_config(config_path)
    if cfg["model_type"] != "Transducer":
        raise ValueError(f"{config_path} is a {cfg['model_type']} config")
    params = [dict(cfg[k]) for k in ("encoder_params", "decoder_params", "joint_params")]
    if dtype != torch.float32:
        for p in params:
            p["compute_dtype"] = str(dtype).removeprefix("torch.")
    model = Transducer(*params, cfg["decoder_params"]["vocab_size"])
    init_params_(model, generator if generator is not None else torch.Generator().manual_seed(0))
    return model.to(device).eval()


def greedy_token_cap(encoder_params: dict, audio_samples: int, max_consec: int) -> int:
    """Upper bound on greedy emissions from the input length alone (each
    encoder frame emits at most ``max_consec`` tokens), rounded up to a
    multiple of 32 (runtime.py:75-84)."""
    f = encoder_output_frames(encoder_params, audio_samples)
    cap = max(f * max_consec, 32)
    return -(-cap // 32) * 32


@torch.inference_mode()
def greedy_decode(model: Transducer, x: torch.Tensor, x_len: torch.Tensor, max_tokens: int,
                  max_consec_dec_steps: int = 5, algo: str = "label"):
    """Batched greedy decode of waveforms x (B, T_audio): (tokens
    (B, max_tokens) 0-padded, counts (B,))."""
    f, f_len = model.encoder(x, x_len)
    return decode_frames(model, f, f_len, max_tokens, max_consec_dec_steps, algo)


@torch.inference_mode()
def decode_frames(model: Transducer, f: torch.Tensor, f_len: torch.Tensor, max_tokens: int,
                  max_consec_dec_steps: int = 5, algo: str = "label"):
    """The greedy loop alone, over encoder frames f (B, T, De) with lengths
    f_len: (tokens (B, max_tokens), counts (B,))."""
    if algo not in ("label", "frame"):
        raise ValueError(f"unknown greedy algo {algo!r}")
    loop = _label_loop if algo == "label" else _frame_loop
    return loop(model, f, f_len.long(), max_tokens, max_consec_dec_steps)


def _init_state(model: Transducer, b: int, max_tokens: int, device):
    carry = model.decoder.init_carry(b, device)
    g, carry = model.decoder.step(torch.zeros(b, dtype=torch.long, device=device), carry)
    zeros = torch.zeros(b, dtype=torch.long, device=device)
    # one spare column takes the writes of utterances that emit nothing
    tokens = torch.zeros((b, max_tokens + 1), dtype=torch.long, device=device)
    return g, carry, zeros.clone(), tokens, zeros.clone()


def _commit(model, emit, tok, state, max_tokens):
    """Append ``tok`` where ``emit`` and advance the decoder there."""
    g, carry, consec, tokens, n_tok = state
    b = emit.shape[0]
    pos = torch.where(emit, n_tok, max_tokens)
    tokens[torch.arange(b, device=emit.device), pos] = tok
    g_new, carry_new = model.decoder.step(torch.where(emit, tok, 0), carry)
    g = torch.where(emit[:, None], g_new, g)
    carry = tuple(torch.where(emit[None, :, None], new, old) for new, old in zip(carry_new, carry))
    return g, carry, tokens, n_tok + emit.long()


def _label_loop(model, f, f_len, max_tokens, max_consec):
    """One iteration per emission (transducer.py:251-337): between two
    emissions the decoder state is constant, so the joint of that state
    against every frame is one (B, T, V) product, and the next emission is
    at the first non-blank frame from t (from t + 1 once the cap is hit)."""
    b, t_max = f.shape[:2]
    g, carry, consec, tokens, n_tok = _init_state(model, b, max_tokens, f.device)
    t = torch.zeros_like(n_tok)
    pf = model.joint_network.project_encoder(f)
    frames = torch.arange(t_max, device=f.device)[None, :]
    rows = torch.arange(b, device=f.device)
    while bool((t < f_len).any()):
        t_star = torch.where(consec >= max_consec, t + 1, t)
        pred = model.joint_network.row(pf, g).argmax(-1)
        nonblank = (frames >= t_star[:, None]) & (frames < f_len[:, None]) & (pred != 0)
        j = nonblank.int().argmax(1)                     # the first non-blank frame
        emit = nonblank.any(1) & (n_tok < max_tokens) & (t < f_len)
        if max_consec < 1:
            # the frame-sync machine (consec < cap never true) emits nothing
            emit = torch.zeros_like(emit)
        tok = pred[rows, j]
        g, carry, tokens, n_tok = _commit(model, emit, tok, (g, carry, consec, tokens, n_tok),
                                          max_tokens)
        consec = torch.where(emit, torch.where(j == t, consec + 1, 1), 0)
        t = torch.where(emit, j, f_len)
    return tokens[:, :max_tokens], n_tok


def _frame_loop(model, f, f_len, max_tokens, max_consec):
    """One iteration per frame advance or emission (transducer.py:192-248).
    The frames are projected once for all steps, as the label loop does,
    which is the same arithmetic as projecting each frame in its step."""
    b, t_max = f.shape[:2]
    g, carry, consec, tokens, n_tok = _init_state(model, b, max_tokens, f.device)
    t = torch.zeros_like(n_tok)
    pf = model.joint_network.project_encoder(f)
    rows = torch.arange(b, device=f.device)
    while bool((t < f_len).any()):
        active = t < f_len
        pf_t = pf[rows, t.clamp(max=t_max - 1)]
        pred = model.joint_network.row(pf_t[:, None], g)[:, 0].argmax(-1)
        emit = active & (pred != 0) & (consec < max_consec) & (n_tok < max_tokens)
        g, carry, tokens, n_tok = _commit(model, emit, pred, (g, carry, consec, tokens, n_tok),
                                          max_tokens)
        t = t + (active & ~emit).long()
        consec = torch.where(emit, consec + 1, 0)
    return tokens[:, :max_tokens], n_tok
