"""Deterministic synthetic token pipeline, sharded per host.

A copy of the reference's ``data.pipeline`` (numpy only), so the port
trains on the same stream bit for bit.

Production shape: each host materializes only its shard of the global batch
(`host_slice`), prefetches ahead of the step loop, and supports *hedged*
reads (straggler mitigation: send a duplicate read for the slowest shard
and take the first to arrive — here simulated, interface real).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    prefetch: int = 2
    hedge: bool = False          # straggler mitigation (duplicate reads)


def _batch_at(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Deterministic batch as a function of (seed, step) only — any host can
    regenerate any shard, which is what makes hedged/elastic reads trivial."""
    rng = np.random.default_rng((cfg.seed, step))
    B, S = cfg.global_batch, cfg.seq_len
    # Markov-ish synthetic stream with local structure (so loss can fall)
    base = rng.integers(0, cfg.vocab, (B, 1), dtype=np.int32)
    drift = rng.integers(-3, 4, (B, S), dtype=np.int32)
    toks = (base + np.cumsum(drift, 1)) % cfg.vocab
    tokens = toks.astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1                       # masked
    return {"tokens": tokens, "labels": labels}


def host_slice(cfg: DataConfig, batch: Dict[str, np.ndarray]
               ) -> Dict[str, np.ndarray]:
    per = cfg.global_batch // cfg.n_hosts
    lo = cfg.host_id * per
    return {k: v[lo:lo + per] for k, v in batch.items()}


class Pipeline:
    """Background-thread prefetching iterator over deterministic batches."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _produce_one(self, step: int) -> Dict[str, np.ndarray]:
        full = _batch_at(self.cfg, step)
        if self.cfg.hedge:
            # hedged read: regenerate the shard through the alternate path
            # and take the first result (identical by determinism)
            alt = host_slice(self.cfg, _batch_at(self.cfg, step))
            return alt
        return host_slice(self.cfg, full)

    def _producer(self):
        s = self.step
        while not self._stop.is_set():
            try:
                self._q.put((s, self._produce_one(s)), timeout=0.5)
                s += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        self.step = step + 1
        return step, batch

    def close(self):
        self._stop.set()
