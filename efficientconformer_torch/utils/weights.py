"""Weights carried between the JAX package and the port.

The port's ``state_dict`` has the original PyTorch repo's keys and layouts
(``encoder.blocks.N.feed_forward_module1.layers.1.weight``, ...), so the JAX
package's ``utils/torch_compat.convert_ctc(port.state_dict())`` is the
port -> JAX map, and published reference checkpoints load into the port
directly. ``from_jax`` is its inverse: the JAX ``{"params", "batch_stats"}``
tree of a ModelCTC (numpy or array leaves) -> a state dict the port loads.

Layouts, JAX -> torch:
  Dense kernel (in, out)                  -> Linear weight (out, in)
  pointwise Dense kernel (in, out)        -> Conv1d weight (out, in, 1)
  Conv1d kernel (k, in/g, out)            -> Conv1d weight (out, in/g, k)
  Conv2d kernel (k_time, k_mel, in, out)  -> Conv2d weight (out, in, k_mel, k_time)
  input projection, mel-major (mel*C, D)  -> weight (D, C*mel), channel-major
  scale/bias, batch_stats mean/var        -> weight/bias, running_mean/var
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _dense(sd, key, p):
    sd[f"{key}.weight"] = _np(p["kernel"]).T
    sd[f"{key}.bias"] = _np(p["bias"])


def _pointwise(sd, key, p):
    sd[f"{key}.weight"] = _np(p["kernel"]).T[:, :, None]
    sd[f"{key}.bias"] = _np(p["bias"])


def _conv1d(sd, key, p):
    sd[f"{key}.weight"] = _np(p["kernel"]).transpose(2, 1, 0)
    sd[f"{key}.bias"] = _np(p["bias"])


def _norm(sd, key, p):
    sd[f"{key}.weight"] = _np(p["scale"])
    sd[f"{key}.bias"] = _np(p["bias"])


def _batch_norm(sd, key, p, stats):
    _norm(sd, key, p)
    sd[f"{key}.running_mean"] = _np(stats["mean"])
    sd[f"{key}.running_var"] = _np(stats["var"])
    sd[f"{key}.num_batches_tracked"] = np.array(0, np.int64)


def _indexed(tree, prefix: str) -> list:
    """Entries ``{prefix}{i}`` of a tree, ordered by i."""
    found = [(int(m.group(1)), k) for k in tree if (m := re.fullmatch(prefix + r"(\d+)", k))]
    return [tree[k] for _, k in sorted(found)]


def from_jax(variables) -> dict[str, torch.Tensor]:
    """JAX ModelCTC variables -> port ``state_dict`` (fp32, CPU tensors)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    enc, enc_stats = params["encoder"], stats["encoder"]
    sd: dict = {}

    sub, sub_stats = enc["subsampling"], enc_stats["subsampling"]
    convs = _indexed(sub, "conv_")
    for i, (conv, bn, bn_stats) in enumerate(
            zip(convs, _indexed(sub, "bn_"), _indexed(sub_stats, "bn_"), strict=True)):
        key = f"encoder.subsampling_module.layers.{i}"
        sd[f"{key}.0.weight"] = _np(conv["kernel"]).transpose(3, 2, 1, 0)
        sd[f"{key}.0.bias"] = _np(conv["bias"])
        _batch_norm(sd, f"{key}.1", bn, bn_stats)
    channels = _np(convs[-1]["kernel"]).shape[-1]
    lin = _np(enc["linear"]["kernel"])                       # (mel*C, D), mel-major
    in_f, out_f = lin.shape
    sd["encoder.linear.weight"] = (
        lin.T.reshape(out_f, in_f // channels, channels).transpose(0, 2, 1).reshape(out_f, in_f))
    sd["encoder.linear.bias"] = _np(enc["linear"]["bias"])

    for i, (blk, blk_stats) in enumerate(
            zip(_indexed(enc, "block_"), _indexed(enc_stats, "block_"), strict=True)):
        key = f"encoder.blocks.{i}"
        for j in (1, 2):
            ffn, fkey = blk[f"ffn{j}"], f"{key}.feed_forward_module{j}.layers"
            _norm(sd, f"{fkey}.0", ffn["ln"])
            _dense(sd, f"{fkey}.1", ffn["fc1"])
            _dense(sd, f"{fkey}.4", ffn["fc2"])
        att, akey = blk["mhsa_module"], f"{key}.multi_head_self_attention_module"
        _norm(sd, f"{akey}.norm", att["ln"])
        for name in ("query", "key", "value", "output", "pos"):
            _dense(sd, f"{akey}.mhsa.{name}_layer", att["mhsa"][name])
        sd[f"{akey}.mhsa.u"] = _np(att["mhsa"]["u"])
        sd[f"{akey}.mhsa.v"] = _np(att["mhsa"]["v"])
        conv, ckey = blk["conv_module"], f"{key}.convolution_module.layers"
        _norm(sd, f"{ckey}.0", conv["ln"])
        _pointwise(sd, f"{ckey}.2", conv["pw1"])
        _conv1d(sd, f"{ckey}.4", conv["dw"])
        _batch_norm(sd, f"{ckey}.5", conv["bn"], blk_stats["conv_module"]["bn"])
        _pointwise(sd, f"{ckey}.7", conv["pw2"])
        if "conv_res" in blk:
            _conv1d(sd, f"{key}.conv_res.1", blk["conv_res"])
        _norm(sd, f"{key}.norm", blk["norm"])

    _dense(sd, "fc", params["fc"])
    return {k: torch.as_tensor(np.array(v, order="C")) for k, v in sd.items()}
