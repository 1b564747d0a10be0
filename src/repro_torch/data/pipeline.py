"""Data pipeline: a deterministic synthetic corpus and host-side
prefetch, the port's own copy of src/repro/data/pipeline.py.

No external datasets ship with the repository, so the pipeline
synthesizes a structured token stream (Zipf-distributed unigrams and
periodic copy spans) that a small dLLM can measurably learn.  The corpus
draws with numpy exactly as JAX's does, so ``SyntheticCorpus.batch(step)``
equals JAX's bit for bit.  ``motif_pool_batch`` draws its pool and picks
with numpy where JAX's draws with ``jax.random``: same shapes, period and
value range, other tokens (ROADMAP.md, Queue 3).  Batches are int32 numpy
arrays; the train step moves them to its device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    pattern_frac: float = 0.5   # fraction of copy-pattern spans
    zipf_a: float = 1.2


class SyntheticCorpus:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def _zipf_tokens(self, rng, n: int) -> np.ndarray:
        v = self.cfg.vocab - 2  # reserve top ids (mask token etc.)
        z = rng.zipf(self.cfg.zipf_a, size=n)
        return np.minimum(z - 1, v - 1).astype(np.int32)

    def batch(self, step: int) -> np.ndarray:
        """(global_batch, seq_len) int32, a function of (seed, step)."""
        cfg = self.cfg
        rng = np.random.RandomState((cfg.seed, step))
        x = self._zipf_tokens(rng, cfg.global_batch * cfg.seq_len)
        x = x.reshape(cfg.global_batch, cfg.seq_len)
        # learnable structure: periodic copy spans  a b c a b c ...
        n_pat = int(cfg.global_batch * cfg.pattern_frac)
        if n_pat:
            period = 8
            motif = rng.randint(0, cfg.vocab - 2,
                                size=(n_pat, period)).astype(np.int32)
            reps = int(np.ceil(cfg.seq_len / period))
            x[:n_pat] = np.tile(motif, (1, reps))[:, :cfg.seq_len]
        return x

    def iter_from(self, step: int) -> Iterator[np.ndarray]:
        """Batches ``step``, ``step + 1``, ...: a resumed or restarted run
        reads the batches of the steps it replays."""
        while True:
            yield self.batch(step)
            step += 1

    def __iter__(self) -> Iterator[np.ndarray]:
        return self.iter_from(0)


def motif_pool_batch(step: int, *, pool_key: int = 42, n_motifs: int = 4,
                     period: int = 4, batch: int = 16, seq_len: int = 64,
                     vocab: int = 257) -> np.ndarray:
    """Periodic sequences drawn from a fixed motif pool (the tiny end task
    of the tests and benchmarks: read the context to identify the motif,
    then continue it): ``n_motifs`` motifs of ``period`` tokens in
    [0, vocab - 2) from ``pool_key``, one picked per row by step.  numpy
    draws, so not JAX's tokens.  -> (batch, seq_len // period * period)
    int32."""
    pool = np.random.RandomState(pool_key).randint(
        0, vocab - 2, size=(n_motifs, period)).astype(np.int32)
    ids = np.random.RandomState((11, step)).randint(0, n_motifs, size=batch)
    return np.tile(pool[ids], (1, seq_len // period))


class Prefetcher:
    """Host-side double buffering (overlaps data synthesis with the device
    step)."""

    def __init__(self, it: Iterator[np.ndarray], depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._it = it
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        for item in self._it:
            if self._stop.is_set():
                return
            self._q.put(item)

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass
