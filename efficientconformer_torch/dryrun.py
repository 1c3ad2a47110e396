"""A multi-rank dry run, and the step of one rank.

``dryrun_multichip(n)`` is the port's counterpart of
``__graft_entry__.dryrun_multichip``: n ranks (one a GPU over NCCL, or with
``device_type="cpu"`` gloo processes on the CPU; without a card the default
raises), the flagship's config shrunk as there (``__graft_entry__.py
:70-78``), and one full training step: the forward pass, the CTC loss, the
backward with DDP's gradient all-reduce and the global BatchNorm
statistics, and the Adam update, on a batch of 2 utterances a data rank. As
there (``__graft_entry__.py:77-99``), four or more ranks (an even count)
add a model axis of 2, tensor parallelism's Megatron layers, and eight or
more (a multiple of 8) a seq axis of 2 between them, the encoder's
activations split along time, on 20160-sample utterances (frames 64 / 32 /
16 through the strided blocks: every point splits). It prints the grid,
the loss, the gradient norm and the collectives issued: DDP's gradient
buckets, BatchNorm's statistics, the model groups' all-reduces and
all-gathers and the seq groups' all-gathers, halos and reduce-scatters.

    python -m efficientconformer_torch.dryrun [N] [--cpu]

``shard_step`` is one rank's step of a global batch, which the data-parallel
checks run in every rank and hold to the one-process step.
"""

from __future__ import annotations

import argparse
import copy
import sys
from typing import Optional

import numpy as np
import torch

from efficientconformer_torch.config import load_config
from efficientconformer_torch.parallel import mesh, sequence, tensor

FLAGSHIP = "configs/EfficientConformerCTCSmall.json"
SP_SAMPLES = 20160   # __graft_entry__.py:87-89: 127 mel frames -> 64 -> 32 -> 16
# the shrunk encoder of __graft_entry__.py:70-78
TINY_ENCODER = {"num_blocks": 5, "dim_model": [16, 24, 32], "num_heads": 2, "ff_ratio": 2,
                "kernel_size": 7, "strided_blocks": [1, 3], "expand_blocks": [1, 3],
                "subsampling_filters": [16], "max_pos_encoding": 512}


def kernel_launches() -> dict:
    """Every kernel's launch counter, by the counter's name."""
    from efficientconformer_torch.ops import bias_attention as BA
    from efficientconformer_torch.ops import rel_attention as RA
    from efficientconformer_torch.ops import rnnt_loss as RL

    counters = {"relpos_fwd": RA.relpos_attention, "relpos_bwd": RA.relpos_attention_bwd,
                "bias_fwd": BA.bias_attention, "bias_bwd": BA.bias_attention_bwd}
    out = {}
    for name, fn in counters.items():
        out[name] = fn.launches
        out[name + "_tc"] = fn.tc_launches
    out["rnnt_fwd"], out["rnnt_bwd"] = RL.rnnt_alphas.launches, RL.rnnt_grads.launches
    return out


def reset_kernel_launches() -> None:
    from efficientconformer_torch.ops import bias_attention as BA
    from efficientconformer_torch.ops import rel_attention as RA
    from efficientconformer_torch.ops import rnnt_loss as RL

    for fn in (RA.relpos_attention, RA.relpos_attention_bwd, BA.bias_attention,
               BA.bias_attention_bwd):
        fn.launches = fn.tc_launches = 0
    RL.rnnt_alphas.launches = RL.rnnt_grads.launches = 0


def shard_step(config: dict, batch: dict, seed: int = 0, adam: Optional[tuple] = None,
               ddp: Optional[bool] = None, steps: int = 1, device=None,
               weights: Optional[dict] = None, grads: bool = False,
               allow_tf32: Optional[bool] = None) -> dict:
    """In one rank of a process group (or in one process): a Trainer of
    ``config`` with weights from ``seed`` (or the state dict ``weights``)
    and, from ``adam`` = (mu, nu, count), the optimizer's moments by
    parameter name and its step counter (``utils.weights.set_adam_state``),
    takes ``steps`` steps of this rank's shard (``mesh.shard_batch``) of
    the global ``batch`` (arrays stacked (A, B, ...)). ``allow_tf32``, if
    given, sets TF32 for matmuls and cuDNN in this process. On the host:
    the last step's loss and gradient norm, the parameters and buffers after
    it (and its gradients, with ``grads``), the kernel launches of the last
    step, DDP's gradient all-reduces and BatchNorm's statistics
    all-reduces over the steps, the model and seq groups' collectives of the
    last step, and on the card the peak memory allocated over the steps."""
    from torch.distributed.algorithms.ddp_comm_hooks import default_hooks

    from efficientconformer_torch.training.trainer import Trainer
    from efficientconformer_torch.utils.weights import set_adam_state

    if allow_tf32 is not None:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = allow_tf32
    trainer = Trainer(copy.deepcopy(config), device=device, seed=seed, ddp=ddp)
    if weights is not None:
        trainer.model.load_state_dict(tensor.localize_state_dict(trainer.model, weights),
                                      strict=True)
    if adam is not None:
        mu, nu, count = adam
        set_adam_state(trainer.optimizer, trainer.model, mu, nu, count)
        trainer.step = count
    counts = {"ddp": 0}
    if trainer.ddp is not None:
        group = mesh.replica_group()

        def counting_hook(state, bucket):
            state["ddp"] += 1
            # over the data x seq group, as DDP's own reduction (None: the world)
            return default_hooks.allreduce_hook(group, bucket)

        trainer.ddp.register_comm_hook(counts, counting_hook)
    mine = mesh.shard_batch({k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()})
    if trainer.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(trainer.device)
    mesh.all_reduce_sum.calls = 0
    for _ in range(steps):
        reset_kernel_launches()
        tensor.reset_calls()
        sequence.reset_calls()
        loss, grad_norm = trainer.train_step(mine)
    tp_calls, sp_calls = dict(tensor.calls), dict(sequence.calls)
    peak = None
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)
        peak = torch.cuda.max_memory_allocated(trainer.device)
    model = trainer.model

    def host(tensors):
        return {n: t.detach().cpu().clone() for n, t in tensors.items()}

    # the full layout (gathered over the model group), and the replicated
    # parameters as this rank holds them
    named = dict(model.named_parameters())
    return {"loss": float(loss), "grad_norm": float(grad_norm),
            "params": host(tensor.gather_tensors(model, named)),
            "grads": host(tensor.gather_tensors(model, {n: p.grad for n, p in named.items()}))
            if grads else None,
            "buffers": host(tensor.gather_tensors(model, dict(model.named_buffers()))),
            "replicated": host({n: p for n, p in named.items()
                                if getattr(p, "tp_shard", None) is None}),
            "launches": kernel_launches(), "ddp_all_reduces": counts["ddp"],
            "bn_all_reduces": mesh.all_reduce_sum.calls, "tp_calls": tp_calls,
            "sp_calls": sp_calls, "rank": mesh.rank(), "world": mesh.world_size(),
            "data_rank": mesh.data_rank(), "seq_rank": mesh.seq_rank(),
            "seq_size": mesh.seq_size(), "model_rank": mesh.model_rank(),
            "model_size": mesh.model_size(), "ddp": trainer.ddp is not None,
            "peak_bytes": peak}


def shard_steps(cases: list) -> list:
    """``shard_step(**case)`` for each case in turn, in this rank."""
    return [shard_step(**case) for case in cases]


def tiny_config() -> dict:
    """The flagship's config with __graft_entry__'s shrunk encoder, fp32,
    one microbatch a step."""
    cfg = load_config(FLAGSHIP)
    cfg["encoder_params"].update(TINY_ENCODER)
    cfg["training_params"].update(accumulated_steps=1, mixed_precision=False)
    return cfg


def example_batch(batch_size: int, vocab: int, t: int = 16000) -> dict:
    """The JAX runtime's ``example_microbatch`` (1 s of noise, 6 labels; ``t``
    samples) as one stacked microbatch."""
    rng = np.random.default_rng(0)
    u = 6
    return {"audio": (rng.standard_normal((1, batch_size, t)) * 0.01).astype(np.float32),
            "labels": rng.integers(1, min(8, vocab), (1, batch_size, u)).astype(np.int32),
            "audio_len": np.full((1, batch_size), t, np.int32),
            "label_len": np.full((1, batch_size), u, np.int32)}


def dryrun_multichip(n_devices: int, device_type: str = "cuda") -> dict:
    """One training step of the shrunk flagship over ``n_devices`` ranks:
    the card's GPUs (without a card this raises, as ``mesh.launch`` does), or
    gloo processes on the CPU with ``device_type`` "cpu". Data x seq 2 x
    model 2 at a multiple of 8, data x model 2 at four or more (an even
    count), data parallel otherwise; prints and returns rank 0's loss,
    gradient norm and collective counts."""
    model_parallel = 2 if n_devices >= 4 and n_devices % 2 == 0 else 1
    seq_parallel = 2 if n_devices >= 8 and n_devices % 8 == 0 else 1
    cfg = tiny_config()
    cfg["training_params"].update(model_parallel=model_parallel, seq_parallel=seq_parallel)
    data = n_devices // (model_parallel * seq_parallel)
    batch = example_batch(2 * data, cfg["tokenizer_params"]["vocab_size"],
                          SP_SAMPLES if seq_parallel > 1 else 16000)
    outs = mesh.launch(shard_step, n_devices, (cfg, batch), device_type=device_type,
                       threads=1 if device_type == "cpu" else None)
    first = outs[0]
    for o in outs[1:]:
        if o["loss"] != first["loss"] or o["grad_norm"] != first["grad_norm"]:
            raise RuntimeError(f"ranks disagree: rank 0 {first['loss']}, rank {o['rank']} "
                               f"{o['loss']}")
        for name, p in first["params"].items():
            if not torch.equal(o["params"][name], p):
                raise RuntimeError(f"rank {o['rank']} updated {name} otherwise than rank 0")
    grid = {"data": data, "seq": seq_parallel, "model": model_parallel}
    result = {"world": n_devices, "device": device_type, **grid,
              "loss": first["loss"], "grad_norm": first["grad_norm"],
              "all_reduces": {"ddp_gradient_buckets": first["ddp_all_reduces"],
                              "batch_norm_statistics": first["bn_all_reduces"]}}
    if model_parallel > 1:
        result["model_group"] = first["tp_calls"]
    if seq_parallel > 1:
        result["seq_group"] = first["sp_calls"]
    if model_parallel * seq_parallel > 1:
        kind = " x ".join(f"{k} {v}" for k, v in grid.items() if k == "data" or v > 1) + \
            f" over {n_devices}"
    else:
        kind = f"data parallel over {n_devices}"
    print(f"dryrun_multichip ok ({kind} {device_type} rank(s)):",
          {"loss": result["loss"], "grad_norm": result["grad_norm"]},
          "all-reduces:", result["all_reduces"],
          *(("model group:", result["model_group"]) if model_parallel > 1 else ()),
          *(("seq group:", result["seq_group"]) if seq_parallel > 1 else ()), flush=True)
    print("grid:", grid, flush=True)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one multi-rank step of the shrunk flagship")
    p.add_argument("n", nargs="?", type=int, default=None,
                   help="ranks (default: the visible GPUs; 2 on --cpu)")
    p.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    a = p.parse_args(argv)
    device_type = "cpu" if a.cpu else "cuda"
    if not a.cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --cpu to run the ranks on the CPU over gloo")
    n = a.n or (2 if a.cpu else torch.cuda.device_count())
    dryrun_multichip(n, device_type)
    return 0


if __name__ == "__main__":
    sys.exit(main())
