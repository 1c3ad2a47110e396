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

# the products whose outputs "dots" keeps: every matrix product and
# convolution of a block reaches one of these
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.baddbmm.default, torch.ops.aten.convolution.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (checkpoint.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_block(block: nn.Module, x, mask, generator, policy: str):
    """``block(x, mask, generator)`` under activation recomputation
    (``policy`` "full" or "dots"), with the recompute drawing the forward's
    dropout masks and leaving BatchNorm's statistics alone."""
    state = generator.get_state() if generator is not None else None
    calls = []

    def run(x, mask):
        if not calls:                      # the forward
            calls.append(1)
            return block(x, mask, generator)
        with frozen_batch_stats():         # the recompute
            if generator is None:
                return block(x, mask, None)
            after = generator.get_state()
            generator.set_state(state)
            try:
                return block(x, mask, generator)
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
        x, x_len = self.subsampling_module(x, x_len)
        t = x.shape[1]
        if self.left_context >= t and self.right_context >= t:
            mask = padding_mask(t, x_len)
        else:
            mask = streaming_mask(t, x_len, self.left_context, self.right_context, x.device)
        x = self.dropout(self.linear(x), generator)
        if self.absolute_pos_enc:
            x = x + absolute_encoding(t, x.shape[-1], x.device).to(x.dtype)
        probs = []
        remat = self.remat if torch.is_grad_enabled() else None
        for i, block in enumerate(self.blocks):
            if remat:
                x = remat_block(block, x, mask, generator, remat)
            else:
                x = block(x, mask, generator)
            s = block.cfg.stride
            if s > 1:
                if mask is not None:
                    mask = mask[:, :, ::s, ::s]
                if x_len is not None:
                    x_len = (x_len - 1) // s + 1
            if i in self.interctc_blocks:
                p = torch.softmax(getattr(self, f"linear_expand_{i}")(x), dim=-1)
                probs.append(p)
                x = x + getattr(self, f"linear_proj_{i}")(p)
        return x, x_len, probs
