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
condition is a host check per iteration here. ``encode``, ``decode_step``,
``joint_step`` and ``decoder_init_carry`` are the steps the beam search
drives (decoding/rnnt_beam_device.py; transducer.py:60-81).
``greedy_decode_stream`` runs either loop over a window of frames from a
carried state (the streaming sessions and the server), and
``reset_state_rows`` puts chosen rows of a state back to a template.
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

    def encode(self, x, x_len):
        """(B, T_audio) -> (frames (B, T, De), f_len) in the compute dtype."""
        return self.encoder(x, x_len)

    def decode_step(self, y_t, carry):
        """One prediction-network step: (B,) tokens -> ((B, Dd), carry)."""
        return self.decoder.step(y_t, carry)

    def joint_step(self, f_t, g_t):
        """(..., De) x (..., Dd) -> (..., V)."""
        return self.joint_network.step(f_t, g_t)

    def decoder_init_carry(self, batch: int, device):
        return self.decoder.init_carry(batch, device)


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
    state = greedy_decode_stream(model, f, f_len, None, max_tokens=max_tokens,
                                 max_consec_dec_steps=max_consec_dec_steps, algo=algo)
    return state[3][:, :max_tokens], state[4]


@torch.inference_mode()
def greedy_decode_stream(model: Transducer, f: torch.Tensor, f_len: torch.Tensor, state=None,
                         *, f_start: Optional[torch.Tensor] = None, max_tokens: int,
                         max_consec_dec_steps: int = 5, algo: str = "label"):
    """Decode the frames f[b, f_start[b]:f_len[b]] of each row (f_start 0
    by default) from a carried ``state`` (a fresh one when None) and return
    the new state (transducer.py:154-190). Each row walks its frames in
    order, so decoding an utterance window by window gives the tokens of
    decoding it whole. The state is the tuple ``init_state`` builds: (g
    (B, Dd), carry (h, c) each (L, B, Dd), consec (B,), tokens (B,
    max_tokens + 1), the last column a spare that takes no token, n_tok
    (B,)); the given state is left as it was."""
    if algo not in ("label", "frame"):
        raise ValueError(f"unknown greedy algo {algo!r}")
    if state is None:
        state = init_state(model, f.shape[0], max_tokens, f.device)
    else:
        # the loops write tokens in place
        state = (*state[:3], state[3].clone(), state[4])
    t = (torch.zeros(f.shape[0], dtype=torch.long, device=f.device) if f_start is None
         else f_start.long().clone())
    loop = _label_loop if algo == "label" else _frame_loop
    return loop(model, f, f_len.long(), t, state, max_tokens, max_consec_dec_steps)


def init_state(model: Transducer, b: int, max_tokens: int, device):
    """The greedy state of ``b`` rows before any frame (transducer.py
    :125-131): the decoder stepped once on the blank."""
    carry = model.decoder.init_carry(b, device)
    g, carry = model.decoder.step(torch.zeros(b, dtype=torch.long, device=device), carry)
    zeros = torch.zeros(b, dtype=torch.long, device=device)
    # one spare column takes the writes of utterances that emit nothing
    tokens = torch.zeros((b, max_tokens + 1), dtype=torch.long, device=device)
    return g, carry, zeros.clone(), tokens, zeros.clone()


def reset_state_rows(state, template, rows: torch.Tensor):
    """``state`` with the rows where ``rows`` (B,) bool is true taken from
    ``template`` (a state of as many rows): one ``torch.where`` per leaf
    along its row axis, the carry's second (serving.py:161-177)."""
    g, carry, consec, tokens, n_tok = state
    tg, tcarry, tconsec, ttokens, tn = template

    def pick(new, old, axis):
        return torch.where(rows.view([-1 if i == axis else 1 for i in range(old.dim())]),
                           new, old)

    return (pick(tg, g, 0), tuple(pick(n, o, 1) for n, o in zip(tcarry, carry)),
            pick(tconsec, consec, 0), pick(ttokens, tokens, 0), pick(tn, n_tok, 0))


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


def _label_loop(model, f, f_len, t, state, max_tokens, max_consec):
    """One iteration per emission (transducer.py:251-337): between two
    emissions the decoder state is constant, so the joint of that state
    against every frame is one (B, T, V) product, and the next emission is
    at the first non-blank frame from t (from t + 1 once the cap is hit).
    Each iteration's loop condition is one host read."""
    g, carry, consec, tokens, n_tok = state
    b, t_max = f.shape[:2]
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
    return g, carry, consec, tokens, n_tok


def _frame_loop(model, f, f_len, t, state, max_tokens, max_consec):
    """One iteration per frame advance or emission (transducer.py:192-248).
    The frames are projected once for all steps, as the label loop does,
    which is the same arithmetic as projecting each frame in its step."""
    g, carry, consec, tokens, n_tok = state
    b, t_max = f.shape[:2]
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
    return g, carry, consec, tokens, n_tok
