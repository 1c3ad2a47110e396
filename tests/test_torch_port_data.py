"""PyTorch port vs the JAX package: the data path, on the CPU.

The WER, the tokenizers (trained, saved, cross-loaded, encoding and
decoding), audio decoding (WAV and FLAC), the dataset preparation
(corpus, tokenizer file, manifests) and both batch loaders, each fed the
same inputs in both packages and held to equal results: strings, tokens,
bytes and arrays bit for bit. The datasets are tests/test_e2e.py's
synthetic mini-LibriSpeech, one utterance of it also as FLAC.
"""

import json
import os
import shutil
import struct
import threading
import wave

import numpy as np
import pytest

from flac_encoder import encode_flac
from test_e2e import SENTENCES, make_dataset

from efficientconformer_tpu.data import audio_io as jax_audio
from efficientconformer_tpu.data import datasets as jax_datasets
from efficientconformer_tpu.data import loader as jax_loader
from efficientconformer_tpu.data import preparation as jax_prep
from efficientconformer_tpu.data import tokenizer as jax_tok
from efficientconformer_tpu.utils.metrics import wer as jax_wer
from efficientconformer_torch.data import audio_io, datasets, loader, native, preparation
from efficientconformer_torch.data import tokenizer as tok
from efficientconformer_torch.utils.metrics import wer

VOCAB = 48

# a seeded lexicon of made-up words: enough distinct words that BPE keeps
# merging well past the alphabet
LEXICON = ["".join(np.random.default_rng(i).choice(list("abcdefghijklmnoprstuvwy"),
                                                   3 + i % 6)) for i in range(300)]


def lexicon_lines(n, seed=0):
    rng = np.random.default_rng(seed)
    return [" ".join(LEXICON[j] for j in rng.zipf(1.3, 4 + i % 9) % len(LEXICON))
            for i in range(n)]


def tokenizer_params(root, name="bpe_48.model"):
    return {"tokenizer_path": os.path.join(root, name), "vocab_type": "bpe",
            "vocab_size": VOCAB}


def training_params(root):
    return {"training_dataset": "LibriSpeech", "training_dataset_path": root + "/"}


def make_flac_dataset(root):
    """tests/test_e2e.py's mini-LibriSpeech, with the first training
    utterance also written as FLAC (the preparation takes a .flac first)."""
    make_dataset(root)
    d = os.path.join(root, "train-clean-100", "1", "1")
    with wave.open(os.path.join(d, "1-1-0000.wav"), "rb") as w:
        x = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    with open(os.path.join(d, "1-1-0000.flac"), "wb") as f:
        f.write(encode_flac(x[None].astype(np.int64), blocksize=1024))


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """The dataset prepared by the port: (root, tokenizer)."""
    root = str(tmp_path_factory.mktemp("data") / "LibriSpeech")
    make_flac_dataset(root)
    t = preparation.create_tokenizer(training_params(root), tokenizer_params(root))
    preparation.prepare_dataset(training_params(root), tokenizer_params(root), t)
    return root, t


# ---------------------------------------------------------------- WER

@pytest.mark.parametrize("truths,preds", [
    (["the cat sat on the mat", "a dog ran"], ["the cat sat on mat", "a dog ran in"]),
    (["it's what they'll do", "we won't and can't"], ["it is what they will do", "won't"]),
    (["let's go [noise] home <unk> now", "i'd say you're right"],
     ["lets go home now", "i would say you are right"]),
    (["the sun is warm today", "rain falls"], ["", ""]),
    (["UPPER Case   spacing\ttabs", "x"], ["upper case spacing tabs", "y"]),
    (["", "one two"], ["", "one"]),
])
@pytest.mark.parametrize("standardize", [True, False])
def test_wer_matches_jax(truths, preds, standardize):
    assert wer(truths, preds, standardize) == jax_wer(truths, preds, standardize)


# ---------------------------------------------------------------- tokenizers

def test_train_bpe_matches_jax():
    lines = SENTENCES * 3 + lexicon_lines(200)
    got, want = tok.train_bpe(lines, 300), jax_tok.train_bpe(lines, 300)
    assert len(got.pieces) == 300
    assert got.pieces == want.pieces and got.merges == want.merges


def test_train_bpe_native_matches_jax_and_python(tmp_path):
    corpus = tmp_path / "corpus.txt"
    lines = SENTENCES * 3 + lexicon_lines(200, seed=1)
    corpus.write_text("\n".join(lines) + "\n")
    got = tok.train_bpe_native(str(corpus), 300)
    want = jax_tok.train_bpe_native(str(corpus), 300)
    py = tok.train_bpe(lines, 300)
    assert got is not None and want is not None
    assert got.pieces == want.pieces == py.pieces
    assert got.merges == want.merges == py.merges


def test_native_library_is_built_under_build():
    path = native.build()
    assert path.parent.name == "native" and path.parent.parent.name == "build"
    assert path.name.startswith("libecf_native-") and path.exists()


@pytest.mark.parametrize("ext", [".model", ".json"])
@pytest.mark.parametrize("saver", ["port", "jax"])
def test_tokenizer_files_cross_load(tmp_path, ext, saver):
    """A tokenizer saved by either package loads in the other, and both
    encode and decode the same."""
    lines = SENTENCES * 2 + lexicon_lines(80, seed=2)
    trained = (tok.train_bpe if saver == "port" else jax_tok.train_bpe)(lines, 120)
    path = str(tmp_path / f"bpe{ext}")
    trained.save(path)
    port, jax_ = tok.BpeTokenizer.load(path), jax_tok.BpeTokenizer.load(path)
    assert port.pieces == jax_.pieces
    texts = lines[:10] + ["unseen wordszz xyz", "", "a", "ünïcødé wörds"]
    for text in texts:
        assert port.encode(text) == jax_.encode(text), text
    ids = [port.encode(t) for t in texts]
    assert port.decode(ids) == jax_.decode(ids)
    if ext == ".model":
        with open(path, "rb") as f:
            data = f.read()
        other = str(tmp_path / f"again{ext}")
        (port if saver == "jax" else jax_).save(other)
        with open(other, "rb") as f:
            assert f.read() == data


def test_python_encoder_matches_native():
    lines = SENTENCES * 2 + lexicon_lines(80, seed=3)
    t = tok.train_bpe(lines, 120)
    assert t._native_encoder() is not None
    py = tok.BpeTokenizer(t.pieces, t.merges)
    py._native_tried = True
    for text in lines[:20] + ["unseen wordszz xyz", "the the the"]:
        assert t.encode(text) == py.encode(text) == jax_tok.BpeTokenizer(
            t.pieces, t.merges).encode(text)


# ---------------------------------------------------------------- audio

def write_wav(path, samples, width):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(width)
        w.setframerate(16000)
        w.writeframes(samples.tobytes())


def write_float_wav(path, samples):
    """An IEEE-float (format 3) WAV, written by hand."""
    data = samples.astype("<f4").tobytes()
    fmt = struct.pack("<HHIIHH", 3, 1, 16000, 64000, 4, 32)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", len(fmt)) + fmt)
        f.write(b"data" + struct.pack("<I", len(data)) + data)


@pytest.mark.parametrize("kind", ["pcm16", "pcm32", "pcm8", "flac", "flac-stereo"])
def test_audio_decodes_as_jax(tmp_path, kind):
    rng = np.random.default_rng(0)
    x = np.clip(rng.normal(0, 3000, 5000), -32768, 32767).astype(np.int64)
    if kind == "pcm16":
        path = tmp_path / "a.wav"
        write_wav(path, x.astype(np.int16), 2)
    elif kind == "pcm32":
        path = tmp_path / "a.wav"
        write_wav(path, (x * 65536 + 12345).astype(np.int32), 4)
    elif kind == "pcm8":
        path = tmp_path / "a.wav"
        write_wav(path, (x // 256 + 128).astype(np.uint8), 1)
    else:
        path = tmp_path / "a.flac"
        channels = x[None] if kind == "flac" else np.stack([x, x // 2])
        path.write_bytes(encode_flac(channels, blocksize=512, subframe="fixed"))
    got, sr = audio_io.load_audio(str(path))
    want, want_sr = jax_audio.load_audio(str(path))
    assert sr == want_sr == 16000 and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert audio_io.audio_length(str(path)) == jax_audio.audio_length(str(path)) == 5000
    if kind == "flac":
        assert audio_io.flac_backend() == "native"
        np.testing.assert_array_equal(got, x.astype(np.float32) / 32768.0)


def test_float_wav_is_refused_as_jax_refuses_it(tmp_path):
    """Python's wave module reads PCM only: an IEEE-float WAV is refused by
    both packages with the same error."""
    path = str(tmp_path / "f.wav")
    write_float_wav(path, np.linspace(-0.5, 0.5, 100))
    with pytest.raises(wave.Error) as want:
        jax_audio.load_audio(path)
    with pytest.raises(wave.Error) as got:
        audio_io.load_audio(path)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- preparation

def test_preparation_writes_what_jax_writes(tmp_path):
    """Corpus file, tokenizer file and every manifest byte for byte, on one
    tree prepared by each package in turn."""
    root = str(tmp_path / "LibriSpeech")
    make_flac_dataset(root)
    outputs = {}
    for name, prep in (("jax", jax_prep), ("port", preparation)):
        t = prep.create_tokenizer(training_params(root), tokenizer_params(root))
        prep.prepare_dataset(training_params(root), tokenizer_params(root), t)
        files = sorted(f for f in os.listdir(root) if os.path.isfile(os.path.join(root, f)))
        outputs[name] = {}
        for f in files:
            with open(os.path.join(root, f), "rb") as fh:
                outputs[name][f] = fh.read()
            os.remove(os.path.join(root, f))
    assert outputs["port"] == outputs["jax"]
    assert set(outputs["port"]) == {
        "LibriSpeech_corpus.txt", "bpe_48.model", "manifest_dev-clean_bpe_48.jsonl",
        "manifest_test-clean_bpe_48.jsonl", "manifest_train-clean-100_bpe_48.jsonl"}
    manifest = outputs["port"]["manifest_train-clean-100_bpe_48.jsonl"].decode().splitlines()
    assert json.loads(manifest[0])["audio"].endswith("1-1-0000.flac")
    assert json.loads(manifest[1])["audio"].endswith("1-1-0001.wav")


def test_dataset_matches_jax(prepared):
    root, t = prepared
    kw = dict(vocab_type="bpe", vocab_size=VOCAB, audio_max_length=30000,
              label_max_length=40)
    got = datasets.LibriSpeechDataset(root, "train", **kw)
    want = jax_datasets.LibriSpeechDataset(root, "train", **kw)
    assert len(got) == len(want) > 0
    for i in range(len(got)):
        assert vars(got.utterances[i]) == vars(want.utterances[i])
        for a, b in zip(got[i], want[i]):
            np.testing.assert_array_equal(a, b)
    lm = datasets.LibriSpeechDataset(root, "dev-clean", vocab_size=VOCAB, lm_mode=True)
    np.testing.assert_array_equal(
        lm[1], jax_datasets.LibriSpeechDataset(root, "dev-clean", vocab_size=VOCAB,
                                               lm_mode=True)[1])
    assert lm.max_label_len == max(len(u.labels) for u in lm.utterances)
    with pytest.raises(FileNotFoundError):
        datasets.LibriSpeechDataset(root, "dev-other", vocab_size=VOCAB)


# ---------------------------------------------------------------- loaders

def assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("num_workers", [0, 3])
def test_asr_loader_matches_jax(prepared, drop_last, num_workers):
    """Epochs 0 and 1 of a shuffled, bucketed, accumulating loader, and of
    an evaluation loader whose partial tail repeats its last utterance
    (n_valid)."""
    root, _ = prepared
    ds = datasets.LibriSpeechDataset(root, "train", vocab_size=VOCAB)
    jds = jax_datasets.LibriSpeechDataset(root, "train", vocab_size=VOCAB)
    for kw in (dict(batch_size=2, accum_steps=2, shuffle=True, seed=3),
               dict(batch_size=3, shuffle=False)):
        got = loader.AsrBatchLoader(ds, drop_last=drop_last, num_workers=num_workers, **kw)
        want = jax_loader.AsrBatchLoader(jds, drop_last=drop_last, num_workers=num_workers, **kw)
        assert got.audio_edges == want.audio_edges and got.label_pad == want.label_pad
        assert len(got) == len(want)
        for epoch in (0, 1):
            assert_batches_equal(got.epoch(epoch), want.epoch(epoch))


def test_asr_loader_stops_its_thread_and_raises_its_errors(prepared):
    root, _ = prepared
    ds = datasets.LibriSpeechDataset(root, "train", vocab_size=VOCAB)
    before = set(threading.enumerate())
    it = loader.AsrBatchLoader(ds, 1, prefetch=1).epoch(0)
    next(it)
    producer, = [t for t in threading.enumerate()
                 if t not in before and t.name == "AsrBatchLoader.epoch"]
    assert producer.is_alive()
    it.close()      # a consumer that stops early: the producer thread ends
    assert not producer.is_alive()
    ds.utterances[5].audio_path = os.path.join(root, "missing.wav")
    with pytest.raises(FileNotFoundError):
        list(loader.AsrBatchLoader(ds, 1, shuffle=False).epoch(0))
    # the sharded loaders of a two-rank group: each rank gets its half of
    # every microbatch, the halves together the one loader's rows
    ds = datasets.LibriSpeechDataset(root, "train", vocab_size=VOCAB)
    whole = list(loader.AsrBatchLoader(ds, 2, shuffle=False).epoch(0))
    halves = [list(loader.AsrBatchLoader(ds, 2, shuffle=False, shard_id=r, num_shards=2)
                   .epoch(0)) for r in range(2)]
    assert len(halves[0]) == len(halves[1]) == len(whole)
    for w, h0, h1 in zip(whole, *halves):
        for k in ("audio", "labels", "audio_len", "label_len"):
            np.testing.assert_array_equal(np.concatenate([h0[k], h1[k]], axis=1), w[k])
        np.testing.assert_array_equal(h0["n_valid"], w["n_valid"])
    with pytest.raises(AssertionError):
        loader.AsrBatchLoader(ds, 3, num_shards=2)


@pytest.mark.parametrize("shard_id,num_shards,batch_size", [(0, 2, 4), (1, 2, 4), (3, 4, 4)])
def test_sharded_asr_loader_matches_jax(prepared, shard_id, num_shards, batch_size):
    """A rank's shard of every batch, bit for bit the JAX loader's
    (multi-host sharding): shuffled with accumulation, and in evaluation
    order with a partial tail (n_valid) and pad lengths rounded up by
    audio_pad_align."""
    root, _ = prepared
    ds = datasets.LibriSpeechDataset(root, "train", vocab_size=VOCAB)
    jds = jax_datasets.LibriSpeechDataset(root, "train", vocab_size=VOCAB)
    common = dict(shard_id=shard_id, num_shards=num_shards)
    for kw in (dict(batch_size=batch_size // 2, accum_steps=2, shuffle=True, seed=3)
               if batch_size // 2 % num_shards == 0 else dict(batch_size=batch_size, seed=1),
               dict(batch_size=3 * num_shards, shuffle=False, drop_last=False,
                    audio_pad_align=lambda n: -(-n // 640) * 640)):
        got = loader.AsrBatchLoader(ds, **common, **kw)
        want = jax_loader.AsrBatchLoader(jds, **common, **kw)
        assert got.audio_pads == want.audio_pads
        for epoch in (0, 1):
            batches = list(got.epoch(epoch))
            assert_batches_equal(batches, want.epoch(epoch))
            assert all(b["audio"].shape[1] == kw["batch_size"] // num_shards for b in batches)
        if not kw.get("drop_last", True):
            assert any(b["n_valid"].min() < kw["batch_size"] for b in batches)


@pytest.mark.parametrize("drop_last", [True, False])
def test_lm_loader_matches_jax(tmp_path, drop_last):
    """LM batches over a corpus with lines longer than max_len (resampled
    by the dataset's seeded rng), epochs 0 and 1."""
    corpus = tmp_path / "corpus.txt"
    lines = lexicon_lines(43, seed=4)
    corpus.write_text("\n".join(lines) + "\n")
    t = tok.train_bpe(lines, 90)
    jt = jax_tok.BpeTokenizer(t.pieces, t.merges)
    got = loader.LmBatchLoader(datasets.LibriSpeechCorpusDataset(str(corpus), t, max_len=20),
                               4, max_len=20, accum_steps=2, drop_last=drop_last, seed=5)
    idx = corpus.with_name("corpus.txt.idx")
    os.remove(idx)   # the JAX package builds its own index
    want = jax_loader.LmBatchLoader(
        jax_datasets.LibriSpeechCorpusDataset(str(corpus), jt, max_len=20), 4, max_len=20,
        accum_steps=2, drop_last=drop_last, seed=5)
    assert len(got) == len(want)
    for epoch in (0, 1):
        assert_batches_equal(got.epoch(epoch), want.epoch(epoch))


def test_corpus_index_matches_jax(tmp_path):
    corpus = tmp_path / "c.txt"
    corpus.write_text("one\ntwo words\n\nlast line without newline")
    got = np.array(datasets._corpus_index(str(corpus)))
    shutil.copy(corpus, tmp_path / "d.txt")
    want = np.array(jax_datasets._corpus_index(str(tmp_path / "d.txt")))
    np.testing.assert_array_equal(got, want)
