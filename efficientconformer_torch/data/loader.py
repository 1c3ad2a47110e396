"""Bucketed batch loader.

Counterpart of efficientconformer_tpu/data/loader.py, with the same batches
bit for bit: utterances are grouped into a fixed set of audio-length
buckets, each batch is padded to its bucket's length (labels to the
bucket's longest), and the same ``random.Random(seed + epoch)`` shuffles
pick the order. ``accum`` microbatches are stacked on a leading axis, as
``Trainer.train_step`` takes them: dicts of numpy arrays (A, B, ...). Audio
is decoded by a pool of ``num_workers`` threads (the native FLAC decoder
releases the interpreter lock) on a background thread that prefetches
``prefetch`` batches ahead of the consumer.

Data parallelism (``shard_id``/``num_shards``, the JAX loader's multi-host
sharding): every rank computes the same batches from the same seed, pads
each to its bucket's length, and materialises only its slice of each
microbatch (``batch_size`` / ``num_shards`` rows), so every rank gets the
same shapes. ``audio_pad_align`` may round a bucket's pad length up.
"""

from __future__ import annotations

import math
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Sequence

import numpy as np


def make_buckets(max_value: int, n_buckets: int, min_value: int = 0) -> List[int]:
    """Linear bucket boundaries (inclusive upper edges)."""
    step = math.ceil((max_value - min_value) / n_buckets)
    return [min_value + step * (i + 1) for i in range(n_buckets)]


def bucket_of(value: int, edges: Sequence[int]) -> int:
    for i, e in enumerate(edges):
        if value <= e:
            return i
    return len(edges) - 1


class AsrBatchLoader:
    """Batches a LibriSpeechDataset into bucket-padded ASR batches."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        accum_steps: int = 1,
        n_audio_buckets: int = 8,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        prefetch: int = 2,
        num_workers: int = 0,
        shard_id: int = 0,
        num_shards: int = 1,
        audio_pad_align=None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.accum = accum_steps
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_workers = num_workers
        # every rank computes the same batch composition (same seed) and
        # materialises its slice of each microbatch (loader.py:65-72)
        assert batch_size % num_shards == 0, (batch_size, num_shards)
        self.shard_id = shard_id
        self.num_shards = num_shards

        lens = [(u.audio_len, u.label_len) for u in dataset.utterances]
        max_audio = max(l[0] for l in lens)
        # Tiny datasets: fewer buckets than dataset/group would strand every
        # utterance in a partial bucket and (with drop_last) yield ZERO batches.
        group = batch_size * accum_steps
        n_audio_buckets = max(1, min(n_audio_buckets, len(lens) // group or 1))
        self.audio_edges = make_buckets(max_audio, n_audio_buckets)
        # each bucket's pad length, which ``audio_pad_align`` may round up;
        # bucket membership still follows audio_edges
        self.audio_pads = [audio_pad_align(e) if audio_pad_align is not None else e
                           for e in self.audio_edges]
        # per audio bucket, the max label length defines the label pad
        self.label_pad = {}
        for al, ll in lens:
            b = bucket_of(al, self.audio_edges)
            self.label_pad[b] = max(self.label_pad.get(b, 1), ll)

    def __len__(self):
        return len(self.dataset) // (self.batch_size * self.accum)

    def _index_batches(self, epoch: int) -> List[tuple]:
        rng = random.Random(self.seed + epoch)
        order = list(range(len(self.dataset)))
        if self.shuffle:
            rng.shuffle(order)
        buckets: dict[int, List[int]] = {}
        batches: List[tuple] = []
        for i in order:
            b = bucket_of(self.dataset.utterances[i].audio_len, self.audio_edges)
            buckets.setdefault(b, []).append(i)
            if len(buckets[b]) == self.batch_size * self.accum:
                batches.append((b, buckets.pop(b)))
        if not self.drop_last:
            for b, idxs in buckets.items():
                if idxs:
                    batches.append((b, idxs))
        if self.shuffle:
            rng.shuffle(batches)
        return batches

    def _materialise(self, bucket: int, idxs: List[int], pool) -> dict:
        micro = self.batch_size
        # partial tail group (drop_last=False): pad by repeating the last
        # index up to a full microbatch; "n_valid" lets eval trim the dupes
        n_valid = len(idxs)
        a_steps = max(1, -(-len(idxs) // micro))
        idxs = list(idxs) + [idxs[-1]] * (a_steps * micro - len(idxs))
        if self.num_shards > 1:
            local = micro // self.num_shards
            idxs = [i for a in range(a_steps)
                    for i in idxs[a * micro + self.shard_id * local:
                                  a * micro + (self.shard_id + 1) * local]]
            micro = local
        n = len(idxs)
        audio = np.zeros((n, self.audio_pads[bucket]), np.float32)
        labels = np.zeros((n, self.label_pad[bucket]), np.int32)
        audio_len = np.zeros((n,), np.int32)
        label_len = np.zeros((n,), np.int32)
        if pool is not None:
            samples = list(pool.map(self.dataset.__getitem__, idxs))
        else:
            samples = [self.dataset[i] for i in idxs]
        for j, (a, l) in enumerate(samples):
            audio[j, : len(a)] = a
            labels[j, : len(l)] = l
            audio_len[j] = len(a)
            label_len[j] = len(l)

        def stack(x):
            return x.reshape((a_steps, micro) + x.shape[1:])

        return {
            "audio": stack(audio),
            "labels": stack(labels),
            "audio_len": stack(audio_len),
            "label_len": stack(label_len),
            # valid utterances of each global microbatch
            "n_valid": np.asarray([max(0, min(n_valid - a * self.batch_size, self.batch_size))
                                   for a in range(a_steps)], np.int32),
        }

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        """The epoch's batches, materialised on a background thread. A
        consumer that stops early (closing the generator) stops the thread;
        an error on the thread is raised to the consumer."""
        batches = self._index_batches(epoch)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        cancel = threading.Event()
        stop = object()

        def put(item) -> bool:
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def produce(pool):
            for b, idxs in batches:
                if cancel.is_set() or not put(self._materialise(b, idxs, pool)):
                    return

        def worker():
            try:
                if self.num_workers > 1:
                    with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                        produce(pool)
                else:
                    produce(None)
            except Exception as e:          # handed to the consumer, which raises it
                put(e)
                return
            put(stop)

        t = threading.Thread(target=worker, name="AsrBatchLoader.epoch", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            cancel.set()
            t.join()


class LmBatchLoader:
    """Batches a token-sequence dataset into LM batches
    (reference collate LM branch, utils/preprocessing.py:48-60): tokens (B, U)
    0-padded; targets (B, U+1) = tokens shifted with a trailing 0, -1 padded."""

    def __init__(self, dataset, batch_size: int, max_len: int,
                 *, accum_steps: int = 1, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_len = max_len
        self.accum = accum_steps
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last

    def __len__(self):
        n, group = len(self.dataset), self.batch_size * self.accum
        return n // group if self.drop_last else -(-n // group)

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        rng = random.Random(self.seed + epoch)
        order = list(range(len(self.dataset)))
        if self.shuffle:
            rng.shuffle(order)
        micro, accum = self.batch_size, self.accum
        group = micro * accum
        end = len(order) - group + 1 if self.drop_last else len(order)
        for start in range(0, max(end, 0), group):
            idxs = order[start : start + group]
            u = self.max_len
            tokens = np.zeros((group, u), np.int32)
            token_len = np.zeros((group,), np.int32)
            # rows beyond len(idxs) stay all -1 targets: zero valid positions,
            # so padded remainder rows contribute nothing to the CE loss
            targets = np.full((group, u + 1), -1, np.int32)
            for j, i in enumerate(idxs):
                ids = self.dataset[i][:u]
                tokens[j, : len(ids)] = ids
                token_len[j] = len(ids)
                targets[j, : len(ids)] = ids
                targets[j, len(ids)] = 0  # trailing blank/eos like the reference

            def stack(x):
                return x.reshape((accum, micro) + x.shape[1:])

            yield {
                "tokens": stack(tokens),
                "token_len": stack(token_len),
                "targets": stack(targets),
            }
