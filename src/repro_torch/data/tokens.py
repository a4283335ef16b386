"""Deterministic token data pipeline.

A copy of ``repro.data.tokens`` (numpy only, the same ``SeedSequence``
layout, so the same arrays bit for bit), so that the port needs nothing
of ``repro``.

Restart-reproducibility by construction: batch(step) is a pure function of
(seed, step) — no loader state to checkpoint, no skip-replay on resume, and
every host computes exactly its own dp-shard (disjointness tested). A
background prefetch thread keeps ``PREFETCH`` batches ready so host-side
generation overlaps device compute.

The synthetic stream is a mixture of Zipfian unigrams and repeated n-gram
motifs so that a language model has actual structure to learn.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

PREFETCH = 4


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    motif_len: int = 16
    n_motifs: int = 512


def _rng_for(cfg: DataConfig, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard, 0xACC]))


def _motif_table(cfg: DataConfig) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 0xF00D]))
    return rng.integers(0, cfg.vocab_size, (cfg.n_motifs, cfg.motif_len),
                        dtype=np.int32)


def batch_at(cfg: DataConfig, step: int, shard: int = 0,
             n_shards: int = 1) -> dict:
    """The shard's slice of the global batch for ``step`` (pure function)."""
    if cfg.global_batch % n_shards:
        raise ValueError(f"global batch {cfg.global_batch} does not split "
                         f"into {n_shards} shards")
    bs = cfg.global_batch // n_shards
    rng = _rng_for(cfg, step, shard)
    motifs = _motif_table(cfg)
    # Zipfian unigram background
    ranks = np.arange(1, cfg.vocab_size + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = rng.choice(cfg.vocab_size, size=(bs, cfg.seq_len + 1),
                      p=probs).astype(np.int32)
    # splice in motifs (the learnable structure)
    n_splice = (cfg.seq_len // cfg.motif_len) // 2
    for b in range(bs):
        for _ in range(n_splice):
            m = motifs[rng.integers(0, cfg.n_motifs)]
            pos = rng.integers(0, cfg.seq_len + 1 - cfg.motif_len)
            toks[b, pos : pos + cfg.motif_len] = m
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class PrefetchingLoader:
    """Iterator over steps with background generation."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, shard: int = 0,
                 n_shards: int = 1):
        self.cfg = cfg
        self.shard = shard
        self.n_shards = n_shards
        self._q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        self._next = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._next
        while not self._stop.is_set():
            batch = batch_at(self.cfg, step, self.shard, self.n_shards)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.2)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        """Stop the prefetch thread and wait for it (it checks the stop
        flag at least every 0.2 s; a batch in the making finishes first)."""
        self._stop.set()
        self._thread.join(timeout=60)
