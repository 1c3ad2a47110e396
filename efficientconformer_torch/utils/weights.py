"""Weights carried between the JAX package and the port.

The port's ``state_dict`` has the original PyTorch repo's keys and layouts
(``encoder.blocks.N.feed_forward_module1.layers.1.weight``,
``decoder.embedding.weight``, ``decoder.rnn.weight_ih_l0``,
``joint_network.linear_encoder.weight``, ...), so the JAX package's
``utils/torch_compat.convert_ctc`` / ``convert_transducer`` /
``convert_lm(port.state_dict())`` is the port -> JAX map for the CTC, the
Transducer and the RNN LM, and published reference checkpoints load into the
port directly. ``from_jax`` is its inverse: the JAX ``{"params",
"batch_stats"}`` tree of a ModelCTC, a Transducer or a LanguageModel (numpy
or array leaves) -> a state dict the port loads. No Transformer LM
checkpoint of the original exists (its TransformerBlock never built), so
the LM-Transformer's keys follow the port's scheme:
``decoder.blocks.N.multi_head_self_attention_module.mhsa.query_layer.weight``,
``decoder.blocks.N.feed_forward_module.layers.{0,1,3}`` (LayerNorm, fc1,
fc2).
``load_adam_state`` carries optimizer state across too: the optax Adam
moments (``mu``, ``nu``, trees shaped like the params) and ``count`` become
``torch.optim.Adam`` state, through the same layout map (moments are
elementwise, so they transpose with their parameters).

Layouts, JAX -> torch:
  Dense kernel (in, out)                  -> Linear weight (out, in)
  LSTM w_ih_lN / w_hh_lN (in, 4H)         -> rnn.weight_ih_lN / weight_hh_lN (4H, in)
  Embedding table (V, D)                  -> embedding.weight (V, D)
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
    if stats is not None:
        sd[f"{key}.running_mean"] = _np(stats["mean"])
        sd[f"{key}.running_var"] = _np(stats["var"])
        sd[f"{key}.num_batches_tracked"] = np.array(0, np.int64)


def _indexed(tree, prefix: str) -> list:
    """Entries ``{prefix}{i}`` of a tree, ordered by i."""
    found = [(int(m.group(1)), k) for k in tree if (m := re.fullmatch(prefix + r"(\d+)", k))]
    return [tree[k] for _, k in sorted(found)]


def from_jax(variables) -> dict[str, torch.Tensor]:
    """JAX ModelCTC, Transducer or LanguageModel variables -> port
    ``state_dict`` (fp32, CPU tensors)."""
    return _state_dict(variables["params"], variables.get("batch_stats", {}))


def params_from_jax(params) -> dict[str, torch.Tensor]:
    """A tree shaped like the JAX ModelCTC, Transducer or LanguageModel
    params -> the port's parameters by name (no BatchNorm statistics)."""
    return _state_dict(params, None)


def _mhsa(sd, key, att):
    """A MultiHeadSelfAttentionModule's pre-LN and rel-pos attention."""
    _norm(sd, f"{key}.norm", att["ln"])
    for name in ("query", "key", "value", "output", "pos"):
        _dense(sd, f"{key}.mhsa.{name}_layer", att["mhsa"][name])
    sd[f"{key}.mhsa.u"] = _np(att["mhsa"]["u"])
    sd[f"{key}.mhsa.v"] = _np(att["mhsa"]["v"])


def _decoder(sd, dec):
    """An RNN decoder (Transducer, LM-RNN) or a Transformer decoder
    (LM-Transformer)."""
    sd["decoder.embedding.weight"] = _np(dec["embedding"]["embedding"])
    for name, val in dec.get("rnn", {}).items():
        kind, which, layer = re.fullmatch(r"([wb])_(ih|hh)_l(\d+)", name).groups()
        key = f"decoder.rnn.{'weight' if kind == 'w' else 'bias'}_{which}_l{layer}"
        sd[key] = _np(val).T if kind == "w" else _np(val)
    for i, blk in enumerate(_indexed(dec, "block_")):
        key = f"decoder.blocks.{i}"
        _mhsa(sd, f"{key}.multi_head_self_attention_module", blk["mhsa_module"])
        ffn, fkey = blk["ffn"], f"{key}.feed_forward_module.layers"
        _norm(sd, f"{fkey}.0", ffn["ln"])
        _dense(sd, f"{fkey}.1", ffn["fc1"])
        _dense(sd, f"{fkey}.3", ffn["fc2"])


def _state_dict(params, stats) -> dict[str, torch.Tensor]:
    sd: dict = {}
    if "encoder" in params:
        _encoder(sd, params["encoder"], stats["encoder"] if stats is not None else None)
    if "fc" in params:
        _dense(sd, "fc", params["fc"])
    if "decoder" in params:
        _decoder(sd, params["decoder"])
    for name, p in params.get("joint_network", {}).items():
        _dense(sd, f"joint_network.{name}", p)
    return {k: torch.as_tensor(np.array(v, order="C")) for k, v in sd.items()}


def _encoder(sd, enc, enc_stats):
    """The Conformer encoder, with its BatchNorm statistics when given."""
    sub = enc["subsampling"]
    convs = _indexed(sub, "conv_")
    bns = _indexed(sub, "bn_")
    bn_stats = (_indexed(enc_stats["subsampling"], "bn_") if enc_stats is not None
                else [None] * len(bns))
    for i, (conv, bn, bn_stat) in enumerate(zip(convs, bns, bn_stats, strict=True)):
        key = f"encoder.subsampling_module.layers.{i}"
        sd[f"{key}.0.weight"] = _np(conv["kernel"]).transpose(3, 2, 1, 0)
        sd[f"{key}.0.bias"] = _np(conv["bias"])
        _batch_norm(sd, f"{key}.1", bn, bn_stat)
    channels = _np(convs[-1]["kernel"]).shape[-1]
    lin = _np(enc["linear"]["kernel"])                       # (mel*C, D), mel-major
    in_f, out_f = lin.shape
    sd["encoder.linear.weight"] = (
        lin.T.reshape(out_f, in_f // channels, channels).transpose(0, 2, 1).reshape(out_f, in_f))
    sd["encoder.linear.bias"] = _np(enc["linear"]["bias"])

    blocks = _indexed(enc, "block_")
    blk_stats = (_indexed(enc_stats, "block_") if enc_stats is not None
                 else [None] * len(blocks))
    for i, (blk, blk_stat) in enumerate(zip(blocks, blk_stats, strict=True)):
        key = f"encoder.blocks.{i}"
        for j in (1, 2):
            ffn, fkey = blk[f"ffn{j}"], f"{key}.feed_forward_module{j}.layers"
            _norm(sd, f"{fkey}.0", ffn["ln"])
            _dense(sd, f"{fkey}.1", ffn["fc1"])
            _dense(sd, f"{fkey}.4", ffn["fc2"])
        _mhsa(sd, f"{key}.multi_head_self_attention_module", blk["mhsa_module"])
        conv, ckey = blk["conv_module"], f"{key}.convolution_module.layers"
        _norm(sd, f"{ckey}.0", conv["ln"])
        _pointwise(sd, f"{ckey}.2", conv["pw1"])
        _conv1d(sd, f"{ckey}.4", conv["dw"])
        _batch_norm(sd, f"{ckey}.5", conv["bn"],
                    blk_stat["conv_module"]["bn"] if blk_stat is not None else None)
        _pointwise(sd, f"{ckey}.7", conv["pw2"])
        if "conv_res" in blk:
            _conv1d(sd, f"{key}.conv_res.1", blk["conv_res"])
        _norm(sd, f"{key}.norm", blk["norm"])


def load_adam_state(optimizer: torch.optim.Adam, model: torch.nn.Module, mu, nu, count) -> None:
    """Set ``optimizer``'s state for ``model``'s parameters from the JAX
    package's optax Adam state: ``mu`` and ``nu`` (trees shaped like the
    ModelCTC, Transducer or LanguageModel params, numpy leaves) and
    ``count`` (updates taken so far)."""
    mu_sd, nu_sd = params_from_jax(mu), params_from_jax(nu)
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(np.asarray(count))),
            "exp_avg": mu_sd[name].to(p.device, p.dtype).clone(),
            "exp_avg_sq": nu_sd[name].to(p.device, p.dtype).clone(),
        }
