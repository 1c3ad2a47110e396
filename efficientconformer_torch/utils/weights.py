"""Weights carried between the JAX package and the port.

The port's ``state_dict`` has the original PyTorch repo's keys and layouts
(``encoder.blocks.N.feed_forward_module1.layers.1.weight``,
``decoder.embedding.weight``, ``decoder.rnn.weight_ih_l0``,
``joint_network.linear_encoder.weight``, ...), so the JAX package's
``utils/torch_compat.convert_ctc`` / ``convert_transducer`` /
``convert_lm(port.state_dict())`` is the port -> JAX map for the CTC (and
InterCTC), the Transducer and the RNN LM. A checkpoint of the original repo
reaches the port through ``python -m efficientconformer_torch.import_checkpoint``
(import_checkpoint.py), which loads its ``model_state_dict`` strictly once
the DDP prefix and the frontend's buffers are dropped, and writes a port
checkpoint and the tokenizer. ``from_jax`` is the inverse map: the JAX ``{"params",
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
elementwise, so they transpose with their parameters). The weights cross
over unchanged under tensor parallelism too: a sharded model loads
``parallel.tensor.shard_state_dict(from_jax(...), model_rank, n)`` (or
``localize_state_dict``), and ``load_adam_state`` cuts the moments to its
shards.

Layouts, JAX -> torch:
  Dense kernel (in, out)                  -> Linear weight (out, in)
  LSTM w_ih_lN / w_hh_lN (in, 4H)         -> rnn.weight_ih_lN / weight_hh_lN (4H, in)
  Embedding table (V, D)                  -> embedding.weight (V, D)
  pointwise Dense kernel (in, out)        -> Conv1d weight (out, in, 1)
  Conv1d kernel (k, in/g, out)            -> Conv1d weight (out, in/g, k)
  Conv2d kernel (k_time, k_mel, in, out)  -> Conv2d weight (out, in, k_mel, k_time)
  subsampling conv_i, bn_i / ln_i          -> subsampling_module.layers.i.0, .1 (VGG's
                                             conv_i_j, bn_i_j: layers.i.{3j}, .{3j + 1})
  input projection, mel-major (mel*C, D)  -> weight (D, C*mel), channel-major
  InterCTC interctc_fc_i / interctc_proj_i -> encoder.linear_expand_i / linear_proj_i
  scale/bias, batch_stats mean/var        -> weight/bias, running_mean/var
  ContextNet modules (``module_from_jax``) -> the same names, the same layouts
"""

from __future__ import annotations

import re

import numpy as np
import torch

from efficientconformer_torch.parallel import tensor


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
    """A MultiHeadSelfAttentionModule's pre-LN and attention (rel-pos with
    pos, u and v; absolute or linear without)."""
    _norm(sd, f"{key}.norm", att["ln"])
    for name in ("query", "key", "value", "output", "pos"):
        if name in att["mhsa"]:
            _dense(sd, f"{key}.mhsa.{name}_layer", att["mhsa"][name])
    for name in ("u", "v"):
        if name in att["mhsa"]:
            sd[f"{key}.mhsa.{name}"] = _np(att["mhsa"][name])


def _decoder(sd, dec, dec_stats):
    """An RNN decoder (Transducer, LM-RNN), a Transformer decoder
    (LM-Transformer) or a Conformer decoder, with its BatchNorm statistics
    when given."""
    sd["decoder.embedding.weight"] = _np(dec["embedding"]["embedding"])
    for name, val in dec.get("rnn", {}).items():
        kind, which, layer = re.fullmatch(r"([wb])_(ih|hh)_l(\d+)", name).groups()
        key = f"decoder.rnn.{'weight' if kind == 'w' else 'bias'}_{which}_l{layer}"
        sd[key] = _np(val).T if kind == "w" else _np(val)
    blocks = _indexed(dec, "block_")
    blk_stats = (_indexed(dec_stats, "block_") if dec_stats else [None] * len(blocks))
    for i, (blk, blk_stat) in enumerate(zip(blocks, blk_stats, strict=True)):
        key = f"decoder.blocks.{i}"
        if "ffn1" in blk:
            _conformer_block(sd, key, blk, blk_stat)
            continue
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
        _decoder(sd, params["decoder"], stats.get("decoder") if stats is not None else None)
    for name, p in params.get("joint_network", {}).items():
        _dense(sd, f"joint_network.{name}", p)
    return {k: torch.as_tensor(np.array(v, order="C")) for k, v in sd.items()}


def _norm_or_stats(sd, key, tree, stats, name):
    """The subsampling norm ``bn_{name}`` (with its statistics) or
    ``ln_{name}`` of a JAX subsampling, if it has one."""
    if f"bn_{name}" in tree:
        _batch_norm(sd, key, tree[f"bn_{name}"],
                    stats[f"bn_{name}"] if stats is not None else None)
    elif f"ln_{name}" in tree:
        _norm(sd, key, tree[f"ln_{name}"])


def _subsampling(sd, sub, sub_stats):
    """Conv1d, Conv2d and Conv2dPool (conv_i, norm_i -> layers.i.0, .1), or
    VGG (conv_i_j, norm_i_j -> layers.i.{0,3}, .{1,4}). Returns the last
    conv's output channels."""
    convs = []
    for name in sub:
        if m := re.fullmatch(r"conv_(\d+)(?:_(\d+))?", name):
            i, j = m.groups()
            convs.append((int(i), int(j) if j is not None else -1, name))
    for i, j, name in sorted(convs):
        kernel = _np(sub[name]["kernel"])
        slot = 3 * j if j >= 0 else 0
        key = f"encoder.subsampling_module.layers.{i}"
        # Conv1d (k, in, out) -> (out, in, k); Conv2d (k_time, k_mel, in, out)
        # -> (out, in, k_mel, k_time)
        sd[f"{key}.{slot}.weight"] = (kernel.transpose(2, 1, 0) if kernel.ndim == 3
                                      else kernel.transpose(3, 2, 1, 0))
        sd[f"{key}.{slot}.bias"] = _np(sub[name]["bias"])
        _norm_or_stats(sd, f"{key}.{slot + 1}", sub, sub_stats, name.removeprefix("conv_"))
    return _np(sub[max(convs)[2]]["kernel"]).shape[-1]


def _conformer_block(sd, key, blk, blk_stat):
    """A ConformerBlock of the encoder or of the Conformer decoder."""
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


def _encoder(sd, enc, enc_stats):
    """The Conformer encoder, with its BatchNorm statistics when given."""
    channels = _subsampling(sd, enc["subsampling"],
                            enc_stats.get("subsampling") if enc_stats is not None else None)
    lin = _np(enc["linear"]["kernel"])                       # (mel*C, D), mel-major
    in_f, out_f = lin.shape
    sd["encoder.linear.weight"] = (
        lin.T.reshape(out_f, in_f // channels, channels).transpose(0, 2, 1).reshape(out_f, in_f))
    sd["encoder.linear.bias"] = _np(enc["linear"]["bias"])

    blocks = _indexed(enc, "block_")
    blk_stats = (_indexed(enc_stats, "block_") if enc_stats is not None
                 else [None] * len(blocks))
    for i, (blk, blk_stat) in enumerate(zip(blocks, blk_stats, strict=True)):
        _conformer_block(sd, f"encoder.blocks.{i}", blk, blk_stat)
    # InterCTC taps, under the original's names (torch_compat.py:155-167)
    for name, p in enc.items():
        if m := re.fullmatch(r"interctc_(fc|proj)_(\d+)", name):
            which = "expand" if m.group(1) == "fc" else "proj"
            _dense(sd, f"encoder.linear_{which}_{m.group(2)}", p)


def module_from_jax(variables) -> dict[str, torch.Tensor]:
    """The JAX variables of one ContextNet module (ContextNetSubsampling,
    ContextNetBlock, DepthwiseSeparableConv1d, SqueezeAndExcitationModule)
    or IdentityProjection -> the port module's ``state_dict`` (the JAX
    names: block_i, conv_i, se, res, res_bn; dw, pw, bn; fc1, fc2; linear).
    No JAX model holds them, so ``from_jax`` never meets them."""
    sd: dict = {}
    _contextnet(sd, "", variables["params"], variables.get("batch_stats"))
    return {k: torch.as_tensor(np.array(v, order="C")) for k, v in sd.items()}


def _contextnet(sd, key, p, stats):
    pre = f"{key}." if key else ""
    for name in ("linear", "fc1", "fc2", "pw"):
        if name in p:
            _dense(sd, pre + name, p[name])
    for conv, norm in (("dw", "bn"), ("res", "res_bn")):
        if conv in p:
            _conv1d(sd, pre + conv, p[conv])
            _batch_norm(sd, pre + norm, p[norm], stats[norm] if stats is not None else None)
    for name in p:
        if re.fullmatch(r"(block|conv)_\d+|se", name):
            _contextnet(sd, pre + name, p[name],
                        stats.get(name, {}) if stats is not None else None)


def load_adam_state(optimizer: torch.optim.Adam, model: torch.nn.Module, mu, nu, count) -> None:
    """Set ``optimizer``'s state for ``model``'s parameters from the JAX
    package's optax Adam state: ``mu`` and ``nu`` (trees shaped like the
    ModelCTC, Transducer or LanguageModel params, numpy leaves) and
    ``count`` (updates taken so far)."""
    set_adam_state(optimizer, model, params_from_jax(mu), params_from_jax(nu), count)


def set_adam_state(optimizer: torch.optim.Adam, model: torch.nn.Module, mu: dict, nu: dict,
                   count) -> None:
    """Set ``optimizer``'s state for ``model``'s parameters: the moments
    ``mu`` and ``nu`` by parameter name (tensors or arrays, in the full
    layout: a model sharded by tensor parallelism takes its shards of
    them) after ``count`` updates."""
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(np.asarray(count))),
            "exp_avg": tensor.local(p, torch.as_tensor(mu[name])).to(p.device, p.dtype).clone(),
            "exp_avg_sq": tensor.local(p, torch.as_tensor(nu[name])).to(p.device,
                                                                         p.dtype).clone(),
        }
