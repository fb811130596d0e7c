"""Deterministic synthetic data pipeline.

A copy of the reference's ``repro/data/pipeline.py`` (numpy and the
stdlib only), kept byte for byte in what it computes: the same
``DataConfig`` gives the same batches in either package.

Design goals (the ones that matter at 1000-node scale):
  * stateless addressing — batch contents are a pure function of
    (seed, step, host_shard), so resume-after-failure needs no replay log
    and elastic re-sharding is exact;
  * per-host sharding — each host materializes only its slice;
  * background prefetch with a bounded queue (straggler smoothing);
  * checkpointable: the only state is the step counter.

The token stream is a seeded Markov-ish mix so the loss actually decreases
(pure uniform tokens would have irreducible loss = log V).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    structure: int = 64   # markov period; larger => more learnable signal


class SyntheticLM:
    """Deterministic, shardable synthetic LM token stream."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.n_hosts == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_hosts
        rng = np.random.default_rng(cfg.seed)
        # fixed transition table: token -> preferred next tokens
        self._table = rng.integers(0, cfg.vocab,
                                   size=(cfg.structure, 8)).astype(np.int64)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of step (and host shard)."""
        cfg = self.cfg
        rows = []
        base = step * cfg.global_batch + self.cfg.host_id * self.local_batch
        for i in range(self.local_batch):
            rng = np.random.default_rng((cfg.seed, base + i))
            start = rng.integers(0, cfg.structure)
            noise = rng.integers(0, cfg.vocab, size=cfg.seq_len)
            choose = rng.integers(0, 8, size=cfg.seq_len)
            idx = (start + np.arange(cfg.seq_len)) % cfg.structure
            toks = self._table[idx, choose]
            mask = rng.random(cfg.seq_len) < 0.15
            toks = np.where(mask, noise, toks)
            rows.append(toks)
        tokens = np.stack(rows).astype(np.int32)
        labels = np.concatenate([tokens[:, 1:],
                                 np.full((self.local_batch, 1), -1,
                                         np.int32)], axis=1)
        return {"tokens": tokens, "labels": labels}


class Prefetcher:
    """Bounded background prefetch; tolerates slow steps (stragglers) by
    keeping up to ``depth`` batches ready."""

    def __init__(self, ds: SyntheticLM, start_step: int = 0, depth: int = 2):
        self.ds = ds
        self.step = start_step
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._next_produce = start_step
        self._thread.start()

    def _work(self):
        while not self._stop.is_set():
            batch = self.ds.batch_at(self._next_produce)
            while not self._stop.is_set():
                try:
                    self._q.put((self._next_produce, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            self._next_produce += 1

    def next(self) -> Dict[str, np.ndarray]:
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def state(self) -> Dict[str, int]:
        return {"step": self.step}

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
