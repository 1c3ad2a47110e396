"""Per-block encoder configuration, and the port's default device.

The same resolution of the reference JSON schema as
efficientconformer_tpu/config.py (``resolve_block_configs``,
``encoder_output_frames``), kept here so that the port imports nothing of the
JAX package. tests/test_torch_port_model.py holds the two to equality on
every shipped config.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional, Sequence

import torch


def default_device() -> torch.device:
    """The card: the port's entry points run there unless the caller names
    another device, and raise without one rather than move to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """Fully-resolved hyperparameters of one Conformer block."""

    block_id: int
    dim_model: int          # input width of the block
    dim_expand: int         # output width (differs on expand blocks)
    ff_ratio: int
    num_heads: int
    kernel_size: int        # depthwise conv kernel
    att_group_size: int
    att_kernel_size: Optional[int]
    linear_att: bool
    dropout: float
    relative_pos_enc: bool
    max_pos_encoding: int
    conv_stride: int
    att_stride: int
    causal: bool

    @property
    def stride(self) -> int:
        return self.conv_stride * self.att_stride


def _count_lt(block_id: int, blocks: Sequence[int]) -> int:
    return sum(1 for b in blocks if b < block_id)


def _count_le(block_id: int, blocks: Sequence[int]) -> int:
    return sum(1 for b in blocks if b <= block_id)


def _pick(value: Any, index: int) -> Any:
    return value[index] if isinstance(value, (list, tuple)) else value


def resolve_block_configs(p: dict) -> list[BlockConfig]:
    """Per-block hyperparameters from raw ``encoder_params``: dim_model (the
    input width) changes after an expand block, dim_expand and kernel_size at
    it."""
    expand = p.get("expand_blocks", [])
    strided = p.get("strided_blocks", [])
    causal = bool(p.get("causal", False))
    blocks = []
    for block_id in range(p["num_blocks"]):
        in_stage = _count_lt(block_id, expand)
        out_stage = _count_le(block_id, expand)
        att_stage = _count_lt(block_id, strided)
        is_strided = block_id in strided
        blocks.append(
            BlockConfig(
                block_id=block_id,
                dim_model=_pick(p["dim_model"], in_stage),
                dim_expand=_pick(p["dim_model"], out_stage),
                ff_ratio=p["ff_ratio"],
                num_heads=_pick(p["num_heads"], in_stage),
                kernel_size=_pick(p["kernel_size"], out_stage),
                att_group_size=_pick(p.get("att_group_size", 1), att_stage),
                att_kernel_size=_pick(
                    p.get("att_kernel_size", None),
                    _count_lt(block_id, p.get("strided_layers", [])),
                ),
                linear_att=bool(p.get("linear_att", False)),
                dropout=p["Pdrop"],
                relative_pos_enc=bool(p["relative_pos_enc"]),
                max_pos_encoding=p["max_pos_encoding"] // p.get("stride", 2) ** att_stage,
                conv_stride=(_pick(p["conv_stride"], att_stage) if is_strided else 1),
                att_stride=(_pick(p["att_stride"], att_stage) if is_strided else 1),
                causal=causal,
            )
        )
    return blocks


def encoder_output_frames(p: dict, audio_samples: int) -> int:
    """Encoder output frames for ``audio_samples`` raw samples: frontend
    T//hop + 1, subsampling (l-1)//2 + 1 per layer (l//2 for VGG), and
    (l-1)//stride + 1 after each strided block."""
    hop = p["sample_rate"] * p["hop_length_ms"] // 1000
    frames = audio_samples // hop + 1
    vgg = p.get("subsampling_module") == "VGG"
    for _ in range(p.get("subsampling_layers", 1)):
        frames = frames // 2 if vgg else (frames - 1) // 2 + 1
    for b in resolve_block_configs(p):
        if b.stride > 1:
            frames = (frames - 1) // b.stride + 1
    return frames


def load_config(path: str) -> dict:
    """The raw JSON config (reference schema)."""
    with open(path) as f:
        return json.load(f)
