"""Dataset preparation (reference utils/preprocessing.py:66-118).

create_tokenizer: build the lower-cased LibriSpeech transcript corpus and train
the BPE tokenizer (reference trains sentencepiece with bos/eos disabled and
empty unk_surface; our BpeTokenizer bakes in those conventions).

prepare_dataset: tokenize every transcript and write per-split manifests
(audio path, audio sample count, label ids) — replacing the reference's
per-utterance torch.save caches.
"""

from __future__ import annotations

import glob
import json
import os

from efficientconformer_torch.data.audio_io import audio_length
from efficientconformer_torch.data.datasets import manifest_path
from efficientconformer_torch.data.tokenizer import BpeTokenizer, train_bpe, train_bpe_native


def _transcripts(dataset_path: str, split_glob: str = "*"):
    """Yield (utterance_id, dir, text) from LibriSpeech *.trans.txt files."""
    pattern = os.path.join(dataset_path, split_glob, "*", "*", "*.txt")
    for file_path in sorted(glob.glob(pattern)):
        d = os.path.dirname(file_path)
        with open(file_path) as f:
            for line in f:
                utt_id, text = line.rstrip("\n").split(" ", 1)
                yield utt_id, d, text.lower()


def create_tokenizer(training_params: dict, tokenizer_params: dict) -> BpeTokenizer:
    dataset_path = training_params["training_dataset_path"]
    corpus_path = os.path.join(
        dataset_path, training_params["training_dataset"] + "_corpus.txt"
    )
    if not os.path.isfile(corpus_path):
        with open(corpus_path, "w") as f:
            for _utt, _d, text in _transcripts(dataset_path):
                f.write(text + "\n")
    tok = train_bpe_native(corpus_path, tokenizer_params["vocab_size"])
    if tok is None:  # no native library: pure-Python fallback
        with open(corpus_path) as f:
            tok = train_bpe(f, tokenizer_params["vocab_size"])
    tok.save(tokenizer_params["tokenizer_path"])
    return tok


def prepare_dataset(training_params: dict, tokenizer_params: dict,
                    tokenizer: BpeTokenizer) -> None:
    dataset_path = training_params["training_dataset_path"]
    splits = sorted(
        os.path.basename(p)
        for p in glob.glob(os.path.join(dataset_path, "*"))
        if os.path.isdir(p)
    )
    for split in splits:
        out = manifest_path(
            dataset_path, split,
            tokenizer_params["vocab_type"], tokenizer_params["vocab_size"],
        )
        entries = []
        for utt_id, d, text in _transcripts(dataset_path, split):
            audio = os.path.join(d, utt_id + ".flac")
            if not os.path.exists(audio):
                wav = os.path.join(d, utt_id + ".wav")
                if os.path.exists(wav):
                    audio = wav
                else:
                    continue
            entries.append(
                {
                    "audio": audio,
                    "audio_len": audio_length(audio),
                    "labels": tokenizer.encode(text),
                }
            )
        if entries:
            with open(out, "w") as f:
                for e in entries:
                    f.write(json.dumps(e) + "\n")
            print(f"wrote {out} ({len(entries)} utterances)")
