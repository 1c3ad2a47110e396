"""Runtime mode dispatch: the CLI's modes over the port.

Counterpart of efficientconformer_tpu/runtime.py (reference main.py:27-178
and Model.evaluate / eval_time* / swa, models/model.py:386-726): config ->
tokenizer -> datasets -> Trainer, then the requested mode. Evaluation
decodes on the device, detokenises and scores the WER on the host: greedy
with ``--gready``, otherwise the beam search of the config's
``decoding_params`` (every shipped config has ``beam_size`` 16, runtime.py
:87-212): the CTC prefix beam with n-gram fusion and the Transducer beam
with n-gram rescoring, both on the device (decoding/), and with
``--initial_epoch_lm`` the LM of ``lm_config`` fused into the Transducer
beam. ``ECF_HOST_BEAM=1`` selects the host beams instead: the C++ CTC
beam, with ``cutoff_top_n``, and the Transducer beams of
decoding/rnnt_beam.py (per utterance with a Transformer LM's growing KV
cache, batched otherwise). ``--profiler`` traces the eval_time modes
(utils/profiling.py). It covers the model types the port has: CTC,
InterCTC, Transducer and LM (the LM trains on the LibriSpeechCorpus text
and is evaluated on transcripts in ``lm_mode``).

What the port does not have raises ``NotImplementedError`` naming its
ROADMAP Queue 1 item, never falling back to something else: tensor,
sequence and data parallelism [14].
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from efficientconformer_torch.config import default_device, load_config
from efficientconformer_torch.data.datasets import LibriSpeechDataset
from efficientconformer_torch.data.loader import AsrBatchLoader, LmBatchLoader
from efficientconformer_torch.data.tokenizer import BpeTokenizer
from efficientconformer_torch.decoding import ctc_beam, rnnt_beam
from efficientconformer_torch.decoding.ctc_beam_device import ctc_beam_search_device
from efficientconformer_torch.decoding.ngram import try_load
from efficientconformer_torch.decoding.rnnt_beam_device import beam_search_device
from efficientconformer_torch.models import model_ctc as ctc_mod
from efficientconformer_torch.models import transducer as rnnt_mod
from efficientconformer_torch.models.layers import _BatchNorm
from efficientconformer_torch.training import checkpoint
from efficientconformer_torch.training.trainer import Trainer
from efficientconformer_torch.utils import profiling
from efficientconformer_torch.utils.metrics import wer

# mode -> (train split, eval split); mirrors reference functions.py:85-227
EVAL_SPLITS = {
    "training": "dev-clean",
    "training-clean": "dev-clean",
    "validation-clean": "dev-clean",
    "validation-other": "dev-other",
    "test-clean": "test-clean",
    "test-other": "test-other",
    "eval_time": "dev-clean",
    "eval_time_encoder": "dev-clean",
    "eval_time_decoder": "dev-clean",
}
TRAIN_SPLITS = {"training": "train", "training-clean": "train-clean"}


def load_tokenizer(config: dict) -> Optional[BpeTokenizer]:
    path = config["tokenizer_params"].get("tokenizer_path")
    try:
        return BpeTokenizer.load(path)
    except (FileNotFoundError, TypeError, json.JSONDecodeError):
        print("Tokenizer not found...")
        return None


def _microbatches(batch: dict) -> dict:
    """A loader batch (A, B, ...) as one batch (A * B, ...)."""
    return {k: v.reshape((-1,) + v.shape[2:]) for k, v in batch.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def decode_batch(trainer: Trainer, batch: dict, tokenizer, max_consec: int = 5,
                 beam_size: int = 1, lm: Optional[dict] = None) -> list:
    """Decode one eval batch (audio (B, T), audio_len (B,), numpy or
    tensors) -> list of B strings: greedy, or with ``beam_size`` > 1 the
    beam search of the config's decoding_params (n-gram fusion when its
    ARPA file exists; ``lm`` a bundle of ``load_lm_for_fusion``)."""
    dev = trainer.device
    model = trainer.model.eval()
    audio = torch.as_tensor(batch["audio"]).to(dev, non_blocking=True)
    audio_len = torch.as_tensor(batch["audio_len"]).to(dev)
    if beam_size > 1:
        return tokenizer.decode(beam_decode(trainer, audio, audio_len, beam_size, max_consec, lm))
    if trainer.config["model_type"] == "Transducer":
        cap = rnnt_mod.greedy_token_cap(trainer.config["encoder_params"], audio.shape[1],
                                        max_consec)
        toks, n = rnnt_mod.greedy_decode(model, audio, audio_len, cap, max_consec)
    else:
        toks, n = ctc_mod.greedy_decode(model, audio, audio_len)
    toks, n = toks.cpu().numpy(), n.cpu().numpy()
    return tokenizer.decode([toks[b, : n[b]].tolist() for b in range(len(n))])


@torch.inference_mode()
def beam_decode(trainer: Trainer, audio: torch.Tensor, audio_len: torch.Tensor,
                beam_size: int, max_consec: int = 5, lm: Optional[dict] = None) -> list:
    """The token lists of the beam search of runtime.py:94-206. CTC: an fp32
    log-softmax of logits / tmp feeds the device prefix beam with the
    n-gram (or, with ECF_HOST_BEAM=1, the host C++ beam with
    ``cutoff_top_n``). Transducer: the device beam with the LM of ``lm`` and
    the n-gram, over at most ``greedy_token_cap`` tokens (or, with
    ECF_HOST_BEAM=1, the host beams of decoding/rnnt_beam.py)."""
    dp = trainer.config["decoding_params"]
    model = trainer.model.eval()
    ngram = try_load(dp.get("ngram_path"), dp.get("ngram_offset", 100))
    alpha, beta = dp.get("ngram_alpha", 0.0), dp.get("ngram_beta", 0.0)
    host = bool(os.environ.get("ECF_HOST_BEAM"))
    if trainer.config["model_type"] == "Transducer":
        fusion = {}
        if lm is not None:
            fusion.update(lm_model=lm["model"], lm_weight=lm["weight"], lm_tmp=lm["tmp"])
        if host:
            # the host beams (runtime.py:131-156): per utterance when a
            # Transformer LM's growing cache rides along, batched otherwise
            fn = (rnnt_beam.beam_search if lm is not None and lm["arch"] == "Transformer"
                  else rnnt_beam.beam_search_batched)
            return fn(model, audio, audio_len, beam_size=beam_size, tmp=dp.get("tmp", 1.0),
                      ngram=ngram, ngram_alpha=alpha, ngram_beta=beta, **fusion)
        if ngram is not None and alpha:
            fusion.update(ngram=ngram, ngram_alpha=alpha, ngram_beta=beta)
        cap = rnnt_mod.greedy_token_cap(trainer.config["encoder_params"], audio.shape[1],
                                        max_consec)
        return beam_search_device(model, audio, audio_len, beam_size=beam_size,
                                  tmp=dp.get("tmp", 1.0), max_tokens=cap, **fusion)
    logits, logits_len = model(audio, audio_len)[:2]
    logp = torch.log_softmax(logits.float() / dp.get("tmp", 1.0), dim=-1)
    if host:
        return ctc_beam.beam_search_batch(
            logp.cpu().numpy(), logits_len.cpu().numpy(), beam_size,
            lm_path=dp.get("ngram_path"), alpha=alpha, beta=beta,
            ngram_offset=dp.get("ngram_offset", 100), cutoff_top_n=dp.get("cutoff_top_n", 0))
    return ctc_beam_search_device(logp, logits_len, beam_size, ngram=ngram, alpha=alpha,
                                  beta=beta)


def load_lm_for_fusion(config: dict, lm_epoch: str, device) -> dict:
    """The shallow-fusion LM of decoding_params["lm_config"] from its
    checkpoint of epoch ``lm_epoch`` (reference main.py:69-79, runtime.py
    :219-238): {model, arch, weight, tmp}."""
    dp = config["decoding_params"]
    lm_config = load_config(dp["lm_config"])
    lm_trainer = Trainer(lm_config, device=device)
    lm_cb = lm_config["training_params"].get("callback_path", "callbacks/")
    lm_trainer.load(os.path.join(lm_cb, f"checkpoints_{lm_epoch}.ckpt"))
    return {"model": lm_trainer.model.eval(), "arch": lm_config["lm_params"]["arch"],
            "weight": dp.get("lm_weight", 0.0), "tmp": dp.get("lm_tmp", 1.0)}


def evaluate(trainer: Trainer, dataset, tokenizer, *, batch_size: int = 8,
             eval_steps: Optional[int] = None, verbose: bool = False, max_consec: int = 5,
             beam_size: int = 1, eval_loss: bool = False, num_workers: int = 0,
             lm: Optional[dict] = None):
    """(WER, truths, predictions, mean eval loss or None) over ``dataset``
    (reference model.py:386-490). The loader repeats a partial tail's last
    utterance to fill its microbatch; those repeats are dropped (``n_valid``)
    before the WER, so each utterance counts once. The eval loss is the mean
    over batches, repeats included, as in the JAX package. ``beam_size``
    and ``lm`` as in ``decode_batch``."""
    loader = AsrBatchLoader(dataset, batch_size, shuffle=False, drop_last=False,
                            num_workers=num_workers)
    truths, preds = [], []
    total_loss, n_loss = 0.0, 0
    for i, batch in enumerate(loader.epoch(0)):
        n_valid = batch.pop("n_valid")
        mb = _microbatches(batch)
        batch_preds = decode_batch(trainer, mb, tokenizer, max_consec, beam_size, lm)
        batch_truths = tokenizer.decode(
            [mb["labels"][b, : mb["label_len"][b]].tolist() for b in range(len(batch_preds))])
        micro = mb["labels"].shape[0] // len(n_valid)
        keep = [a * micro + j for a, nv in enumerate(n_valid) for j in range(int(nv))]
        preds += [batch_preds[j] for j in keep]
        truths += [batch_truths[j] for j in keep]
        if eval_loss:
            total_loss += float(trainer.eval_loss(mb))
            n_loss += 1
        if verbose:
            print("Groundtruths:\n", batch_truths)
            print("Predictions:\n", batch_preds)
        if eval_steps and i + 1 >= eval_steps:
            break
    mean_loss = total_loss / n_loss if n_loss else None
    return wer(truths, preds), truths, preds, mean_loss


def evaluate_lm(trainer: Trainer, dataset, *, batch_size: int = 8,
                eval_steps: Optional[int] = None) -> float:
    """Mean eval cross entropy of an LM over labels-only transcripts
    (reference lm_mode datasets and eval_loss, model.py:438-442)."""
    loader = LmBatchLoader(dataset, batch_size, max_len=dataset.max_label_len,
                           shuffle=False, drop_last=False)
    total, n = 0.0, 0
    for i, batch in enumerate(loader.epoch(0)):
        total += float(trainer.eval_loss(_microbatches(batch)))
        n += 1
        if eval_steps and i + 1 >= eval_steps:
            break
    return total / n if n else float("nan")


def bn_refresh(trainer: Trainer, dataset, steps: int = 100) -> int:
    """Re-estimate the BatchNorm running statistics of ``trainer.model`` as
    the cumulative average of the statistics of shuffled batches of 8
    training utterances (seed 0, epoch 0), at most ``steps`` of them, in
    training mode: torch.optim.swa_utils.update_bn's semantics (reference
    model.py:534-557), as the JAX package's ``bn_refresh`` computes them.
    Each batch's statistics are read directly: the momentum of batch n is
    set to n / (n + 1), so the running value becomes the average of the
    n + 1 batches so far. The number of batches; the statistics are left
    as they were when there was none. BatchNorm lives in the encoder only,
    so only the encoder runs."""
    model = trainer.model
    norms = [m for m in model.modules() if isinstance(m, _BatchNorm)]
    if not norms:
        return 0
    loader = AsrBatchLoader(dataset, 8, shuffle=True)
    generator = torch.Generator(device=trainer.device).manual_seed(0)
    dev = trainer.device
    n = 0
    model.train()
    try:
        with torch.no_grad():
            for i, batch in enumerate(loader.epoch(0)):
                mb = _microbatches(batch)
                for m in norms:
                    m.MOMENTUM = n / (n + 1)
                model.encoder(torch.as_tensor(mb["audio"]).to(dev),
                              torch.as_tensor(mb["audio_len"]).to(dev), generator)
                n += 1
                if i + 1 >= steps:
                    break
    finally:
        for m in norms:
            m.__dict__.pop("MOMENTUM", None)
        model.eval()
    return n


def _refuse(args) -> None:
    """The flags whose work the port does not have."""
    if (args.model_parallel or 1) > 1 or (args.seq_parallel or 1) > 1:
        raise NotImplementedError("--model_parallel / --seq_parallel are not ported: "
                                  "ROADMAP Queue 1 item 14")
    if args.distributed or args.parallel or (args.world_size or 1) > 1:
        raise NotImplementedError("-d / --parallel / --world_size > 1 (more than one GPU) are "
                                  "not ported: ROADMAP Queue 1 item 14")


def run(args) -> int:
    """Run the mode of the parsed CLI ``args`` (main.build_parser)."""
    _refuse(args)
    device = torch.device("cpu") if args.cpu else default_device()
    config = load_config(args.config_file)
    tp = config["training_params"]
    tokenizer = None
    if args.create_tokenizer:
        from efficientconformer_torch.data.preparation import create_tokenizer

        print("Creating Tokenizer")
        tokenizer = create_tokenizer(tp, config["tokenizer_params"])
    if tokenizer is None:
        tokenizer = load_tokenizer(config)
    if args.prepare_dataset:
        from efficientconformer_torch.data.preparation import prepare_dataset

        print("Preparing dataset")
        prepare_dataset(tp, config["tokenizer_params"], tokenizer)

    trainer = Trainer(config, device=device)
    print(config["model_name"])
    print("Model Parameters :", sum(p.numel() for p in trainer.model.parameters()))
    if args.show_dict:
        for name, p in trainer.model.named_parameters():
            print(f"{name:<64} {str(tuple(p.shape)):<16} "
                  f"mean {p.mean().item():<12.4f} std {p.std().item():<12.4f}")

    cb_path = tp.get("callback_path", "callbacks/")
    initial_epoch = 0
    if args.initial_epoch is not None:
        trainer.load(os.path.join(cb_path, f"checkpoints_{args.initial_epoch}.ckpt"))
        initial_epoch = int(args.initial_epoch)
    if args.initial_epoch_encoder is not None:
        enc_path = tp.get("callback_path_encoder", cb_path)
        checkpoint.load_encoder(
            os.path.join(enc_path, f"checkpoints_{args.initial_epoch_encoder}.ckpt"),
            trainer.model)
    # the shallow-fusion LM (reference main.py:69-79)
    lm = load_lm_for_fusion(config, args.initial_epoch_lm, device) if args.initial_epoch_lm \
        else None

    mode_base = args.mode.split("-")[0]
    vocab_type = config["tokenizer_params"]["vocab_type"]
    vocab_size = config["tokenizer_params"]["vocab_size"]

    def eval_dataset():
        return LibriSpeechDataset(
            tp["evaluation_dataset_path"], EVAL_SPLITS.get(args.mode, "dev-clean"),
            vocab_type=vocab_type, vocab_size=vocab_size,
            audio_max_length=tp.get("eval_audio_max_length"),
            label_max_length=tp.get("eval_label_max_length"),
            lm_mode=bool(tp.get("lm_mode")))

    def train_dataset(split):
        return LibriSpeechDataset(
            tp["training_dataset_path"], split, vocab_type=vocab_type, vocab_size=vocab_size,
            audio_max_length=tp.get("train_audio_max_length"),
            label_max_length=tp.get("train_label_max_length"))

    if args.swa:
        return _swa(args, trainer, cb_path, train_dataset("train"))
    if mode_base == "training":
        _train(args, trainer, tokenizer, cb_path, initial_epoch, eval_dataset, train_dataset)
        return 0
    if mode_base in ("validation", "test"):
        ds = eval_dataset()
        if config["model_type"] == "LM":
            loss = evaluate_lm(trainer, ds, batch_size=args.batch_size_eval,
                               eval_steps=args.val_steps)
            print("Eval Loss : {:.4f} | Perplexity : {:.2f}".format(
                loss, math.exp(min(loss, 30.0))))
            return 0
        beam = 1 if args.gready else config["decoding_params"].get("beam_size", 1)
        w, _, _, _ = evaluate(
            trainer, ds, tokenizer, batch_size=args.batch_size_eval, eval_steps=args.val_steps,
            verbose=args.verbose_val, max_consec=args.rnnt_max_consec_dec_steps or 5,
            beam_size=beam, eval_loss=args.eval_loss, num_workers=args.num_workers, lm=lm)
        print("{} Search WER : {:.2f}%".format("Greedy" if beam <= 1 else "Beam", 100 * w))
        return 0
    if mode_base.startswith("eval_time"):
        _eval_time(args, trainer, tokenizer, mode_base, eval_dataset(), cb_path)
        return 0
    raise ValueError(f"unknown mode {args.mode}")


def _swa(args, trainer: Trainer, cb_path: str, train_ds) -> int:
    """Average the checkpoints of the epochs asked for, refresh the
    BatchNorm statistics over training data, save without the optimizer
    (reference model.py:492-568)."""
    epochs = ([int(e) for e in args.swa_epochs_list] if args.swa_epochs_list
              else list(range(int(args.swa_epochs[0]), int(args.swa_epochs[1]) + 1)))
    states = [checkpoint.read(os.path.join(cb_path, f"checkpoints_{e}.ckpt"), trainer.device)
              for e in epochs]
    names = [n for n, _ in trainer.model.named_parameters()]
    average = (checkpoint.swa_average(states, names) if args.swa_type == "equal"
               else checkpoint.swa_exp_average(states, names))
    trainer.model.load_state_dict(average["model"], strict=True)
    trainer.step = average["step"]
    bn_refresh(trainer, train_ds, steps=args.steps_per_epoch or 100)
    tag = f"swa-{args.swa_type}-{epochs[0]}-{epochs[-1]}"
    trainer.save(os.path.join(cb_path, f"checkpoints_{tag}.ckpt"), save_optimizer=False)
    return 0


def _train(args, trainer: Trainer, tokenizer, cb_path: str, initial_epoch: int, eval_dataset,
           train_dataset) -> None:
    config = trainer.config
    tp = config["training_params"]
    if tp.get("training_dataset") == "LibriSpeechCorpus":
        # LM training on the text corpus (reference functions.py:105-117)
        from efficientconformer_torch.data.datasets import LibriSpeechCorpusDataset

        corpus = LibriSpeechCorpusDataset(tp["training_dataset_path"], tokenizer,
                                          max_len=tp.get("train_label_max_length"))
        loader = LmBatchLoader(corpus, tp["batch_size"],
                               max_len=tp.get("train_label_max_length") or 100,
                               accum_steps=tp.get("accumulated_steps", 1))
    else:
        loader = AsrBatchLoader(train_dataset(TRAIN_SPLITS.get(args.mode, "train")),
                                tp["batch_size"], accum_steps=tp.get("accumulated_steps", 1),
                                num_workers=args.num_workers)
    writer = None
    try:
        from tensorboardX import SummaryWriter

        writer = SummaryWriter(os.path.join(cb_path, "logs"))
    except ImportError:
        pass

    val_fn = None
    try:
        val_ds = eval_dataset()
    except FileNotFoundError:
        val_ds = None
    if val_ds is not None and config["model_type"] == "LM":
        def val_fn(tr):
            return {"MeanLoss": evaluate_lm(tr, val_ds, batch_size=args.batch_size_eval,
                                            eval_steps=args.val_steps)}
    elif val_ds is not None and tokenizer is not None:
        def val_fn(tr):
            w, truths, preds, vloss = evaluate(tr, val_ds, tokenizer,
                                               batch_size=args.batch_size_eval,
                                               eval_steps=args.val_steps, eval_loss=True)
            out = {"WER": 100.0 * w}
            if vloss is not None:
                out["MeanLoss"] = vloss
            if truths and preds:
                out["_text"] = "GroundTruth : " + truths[0] + " / Prediction : " + preds[0]
            return out
    try:
        trainer.fit_epochs(loader.epoch, epochs=tp["epochs"],
                           steps_per_epoch=args.steps_per_epoch, initial_epoch=initial_epoch,
                           callback_path=cb_path, val_fn=val_fn,
                           saving_period=args.saving_period, val_period=args.val_period,
                           log_writer=writer)
    finally:
        if writer is not None:
            writer.close()


def _eval_time(args, trainer: Trainer, tokenizer, mode_base: str, ds, cb_path: str) -> None:
    """Time evaluation (reference model.py:570-726): the whole greedy
    evaluation, the encoder alone (a CTC model's whole forward pass), or
    the prediction network stepped token by token over the labels (a
    Transducer's). With ``--profiler`` the timed work runs inside
    torch.profiler, its trace written under ``<callback_path>/profile/``
    and its top-10 table printed before the time (runtime.py:576-630)."""
    dev = trainer.device
    log_dir = os.path.join(cb_path, "profile")
    with (profiling.trace(log_dir, dev) if args.profiler
          else contextlib.nullcontext()) as prof:
        seconds = _timed_eval(args, trainer, tokenizer, mode_base, ds)
    if args.profiler:
        profiling.print_trace_summary(prof, log_dir, dev)
    print("eval time : {:.2f}s".format(seconds))


def _timed_eval(args, trainer: Trainer, tokenizer, mode_base: str, ds) -> float:
    """The work ``_eval_time`` times, in seconds."""
    model, dev = trainer.model.eval(), trainer.device
    t0 = time.perf_counter()
    if mode_base == "eval_time":
        evaluate(trainer, ds, tokenizer, batch_size=args.batch_size_eval,
                 eval_steps=args.val_steps, max_consec=args.rnnt_max_consec_dec_steps or 5)
    else:
        if mode_base == "eval_time_decoder" and trainer.config["model_type"] != "Transducer":
            raise ValueError("eval_time_decoder steps a Transducer's prediction network")
        loader = AsrBatchLoader(ds, args.batch_size_eval, shuffle=False)
        with torch.inference_mode():
            for i, batch in enumerate(loader.epoch(0)):
                mb = _microbatches(batch)
                if mode_base == "eval_time_decoder":
                    labels = torch.as_tensor(mb["labels"]).to(dev).long()
                    carry = model.decoder.init_carry(labels.shape[0], dev)
                    for u in range(labels.shape[1]):
                        g, carry = model.decoder.step(labels[:, u], carry)
                else:
                    forward = (model.encoder if trainer.config["model_type"] == "Transducer"
                               else model)
                    forward(torch.as_tensor(mb["audio"]).to(dev),
                            torch.as_tensor(mb["audio_len"]).to(dev))
                _sync(dev)
                if args.val_steps and i + 1 >= args.val_steps:
                    break
    _sync(dev)
    return time.perf_counter() - t0
