"""Conformer encoder.

Counterpart of efficientconformer_tpu/models/encoders.py:ConformerEncoder:
log-mel frontend (fp32) -> SpecAugment (training, fp32) -> optional cast to
``compute_dtype`` -> subsampling (Conv1d, Conv2d, Conv2dPool or VGG) ->
key-padding mask -> linear projection -> dropout -> the absolute encoding
when the attention has no rel-pos encodings -> Conformer blocks. The mask is
the (B, 1, 1, T) key-padding mask when the attention context
(``left_context``, ``right_context``, both ``max_pos_encoding`` by default;
the right one 0 in a causal encoder) covers the T subsampled frames, and the
(B, 1, T, T) window + padding mask (ops/masks.streaming_mask) otherwise
(encoders.py:99-111). After a block of stride s = conv_stride * att_stride
the mask is sliced ``[::s, ::s]`` and the lengths become (l-1)//s + 1. In
training mode (``train()``) SpecAugment and dropout draw from the generator
passed to ``forward`` and BatchNorm uses batch statistics.
InterCTC (encoders.py:150-166): after each block of ``interctc_blocks`` a
tap takes p = softmax(linear_expand_i(x)) over the vocabulary and adds
linear_proj_i(p) back to x; ``forward_taps`` also returns the taps' p, each
at its block's frame rate (the original's names, ``linear_expand_{i}`` and
``linear_proj_{i}``, i the block's index).

``remat`` (encoders.py:126-146) recomputes each block in the backward pass
instead of keeping its activations: true or "full" keeps only the block's
input (non-reentrant ``torch.utils.checkpoint``); "dots" keeps the outputs of
the matrix products and convolutions (selective checkpointing, the
counterpart of JAX's ``dots_saveable``) and recomputes the elementwise
chains around them. The recompute is the forward's own arithmetic:
  * its dropout masks are the forward's: the block's generator state is
    taken before the forward, the recompute draws from it, and the
    generator is put back where it stood, so that after the step it stands
    where it stands without remat;
  * BatchNorm's running statistics are updated by the forward alone
    (models/layers.frozen_batch_stats around the recompute);
  * variational noise, set on the weights for the whole step, is still
    there when the backward recomputes.
The fused attention kernels inside a block run again in the recompute.

Sequence parallelism (``seq``, set by parallel/sequence.shard_encoder_; the
JAX package's ``seq_constraint`` points, encoders.py:78,96,155): the
frontend and SpecAugment run on the whole audio on every rank of the seq
group (their generator is shared), every subsampling computes the rank's
frames from its window of the whole mel (models/modules.py), and at each
point (after subsampling, after every block) an activation whose frame
count divides by the seq size is split evenly along time; any other runs
whole on every rank, and a block whose output would not split evenly
gathers its input first. The mask and the lengths stay whole (the keys are
gathered), the frame count and the rank's offset travel as a
``sequence.Span`` through every block kind (a strided block's output span
is ``sequence.strided(span, stride)``), the absolute encoding adds its rows
at the rank's offset, the InterCTC taps run on the rank's frames and gather
their probabilities, and the output is gathered whole for the heads.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils import checkpoint

from efficientconformer_torch.config import resolve_block_configs
from efficientconformer_torch.models.blocks import ConformerBlock
from efficientconformer_torch.models.layers import Dropout, Linear, frozen_batch_stats
from efficientconformer_torch.models.modules import (
    SUBSAMPLING,
    AudioPreprocessing,
    SpecAugment,
)
from efficientconformer_torch.ops.masks import padding_mask, streaming_mask
from efficientconformer_torch.ops.pos_enc import absolute_encoding
from efficientconformer_torch.parallel import sequence

# the products whose outputs "dots" keeps: every matrix product and
# convolution of a block reaches one of these
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.baddbmm.default, torch.ops.aten.convolution.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (checkpoint.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_block(block: nn.Module, x, mask, generator, policy: str, span=None):
    """``block(x, mask, generator, span)`` under activation recomputation
    (``policy`` "full" or "dots"), with the recompute drawing the forward's
    dropout masks and leaving BatchNorm's statistics alone. Under sequence
    parallelism the recompute repeats the block's collectives."""
    state = generator.get_state() if generator is not None else None
    calls = []

    def run(x, mask):
        if not calls:                      # the forward
            calls.append(1)
            return block(x, mask, generator, span)
        with frozen_batch_stats():         # the recompute
            if generator is None:
                return block(x, mask, None, span)
            after = generator.get_state()
            generator.set_state(state)
            try:
                return block(x, mask, generator, span)
            finally:
                generator.set_state(after)

    kwargs = {}
    if policy == "dots":
        kwargs["context_fn"] = functools.partial(
            checkpoint.create_selective_checkpoint_contexts, _dots_policy)
    return checkpoint.checkpoint(run, x, mask, use_reentrant=False, preserve_rng_state=False,
                                 **kwargs)


class ConformerEncoder(nn.Module):
    def __init__(self, params: dict, vocab_size: Optional[int] = None,
                 interctc_blocks: Sequence[int] = ()):
        super().__init__()
        p = params
        remat = p.get("remat")
        if remat not in (None, False, True, "full", "dots"):
            raise ValueError(f"remat {remat!r}: false, true, \"full\" or \"dots\"")
        self.remat = "dots" if remat == "dots" else "full" if remat else None
        blocks = resolve_block_configs(p)
        dtype = p.get("compute_dtype")
        self.compute_dtype = getattr(torch, dtype) if dtype else None
        self.left_context = p.get("left_context", p["max_pos_encoding"])
        self.right_context = 0 if p.get("causal", False) else p.get(
            "right_context", p["max_pos_encoding"])
        self.preprocessing = AudioPreprocessing(
            p["sample_rate"], p["n_fft"], p["win_length_ms"], p["hop_length_ms"],
            p["n_mels"], p["normalize"], p["mean"], p["std"])
        self.augment = SpecAugment(p.get("spec_augment", False), p.get("mF", 0), p.get("F", 0),
                                   p.get("mT", 0), p.get("pS", 0.0))
        self.subsampling_module = SUBSAMPLING[p["subsampling_module"]](
            p["subsampling_layers"], p["subsampling_filters"], p["subsampling_kernel_size"],
            p["subsampling_norm"], p["subsampling_act"], in_dim=p["n_mels"])
        self.linear = Linear(self.subsampling_module.out_features(p["n_mels"]),
                             blocks[0].dim_model)
        self.dropout = Dropout(p["Pdrop"])
        self.absolute_pos_enc = not p["relative_pos_enc"]
        self.blocks = nn.ModuleList(ConformerBlock(cfg) for cfg in blocks)
        self.interctc_blocks = tuple(interctc_blocks)
        self.seq = None              # the seq group under sequence parallelism
        for i in self.interctc_blocks:
            self.add_module(f"linear_expand_{i}", Linear(blocks[i].dim_expand, vocab_size))
            self.add_module(f"linear_proj_{i}", Linear(vocab_size, blocks[i].dim_expand))

    def forward(self, x: torch.Tensor, x_len: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """x: (B, T_audio) raw waveform -> (features (B, T, D), lengths).
        ``generator`` (on x's device) feeds SpecAugment and dropout in
        training mode."""
        return self.forward_taps(x, x_len, generator)[:2]

    def forward_taps(self, x: torch.Tensor, x_len: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None):
        """``forward``'s (features, lengths) and the InterCTC taps'
        probabilities, a list of (B, T_i, V) in the compute dtype."""
        x, x_len = self.preprocessing(x, x_len)
        x = self.augment(x, x_len, generator)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        seq, span = self.seq, None
        if seq is None:
            x, x_len = self.subsampling_module(x, x_len)
        else:
            x, x_len, span = self.subsampling_module(x, x_len, seq)
        # the frame count of the whole sequence, which the mask covers
        t = span.total if span is not None else x.shape[1]
        if self.left_context >= t and self.right_context >= t:
            mask = padding_mask(t, x_len)
        else:
            mask = streaming_mask(t, x_len, self.left_context, self.right_context, x.device)
        x = self.dropout(self.linear(x), generator, span)
        if self.absolute_pos_enc:
            enc = absolute_encoding(t, x.shape[-1], x.device)
            if span is not None:
                enc = enc[span.start:span.start + span.length]
            x = x + enc.to(x.dtype)
        probs = []
        remat = self.remat if torch.is_grad_enabled() else None
        for i, block in enumerate(self.blocks):
            s = block.cfg.stride
            if span is not None and not sequence.splits_evenly(t, s, seq.size):
                # the block's output frames would not split evenly: it runs whole
                x, span = sequence.gather_time(x, seq), None
            if remat:
                x = remat_block(block, x, mask, generator, remat, span)
            else:
                x = block(x, mask, generator, span)
            if s > 1:
                t = (t - 1) // s + 1
                span = sequence.strided(span, s) if span is not None else None
                if mask is not None:
                    mask = mask[:, :, ::s, ::s]
                if x_len is not None:
                    x_len = (x_len - 1) // s + 1
            if seq is not None and span is None and t % seq.size == 0:
                # the JAX package's seq_constraint: a point that divides is split
                x, span = sequence.split_time(x, seq), sequence.even(t, seq)
            if i in self.interctc_blocks:
                p = torch.softmax(getattr(self, f"linear_expand_{i}")(x), dim=-1)
                probs.append(p if span is None else sequence.gather_time(p, seq))
                x = x + getattr(self, f"linear_proj_{i}")(p)
        if span is not None:
            x = sequence.gather_time(x, seq)
        return x, x_len, probs
