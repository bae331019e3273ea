"""Deterministic synthetic data pipeline with async prefetch.

The reference's ``repro/data/pipeline.py``: a counter-seeded numpy
generator per (step, host shard), so every run, and every restart, sees
the same batches (resumable from any step), and different DP shards see
disjoint streams; the batches are numpy arrays in the global layout, equal
to the reference's from the same seed.  The Prefetcher runs on the DiOMP
StreamPool; its depth is the knob the straggler monitor boosts.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from ..core.streams import StreamPool
from ..models.config import ModelConfig

__all__ = ["SyntheticLM", "Prefetcher"]


class SyntheticLM:
    """Batch factory for every model family (token / audio / vlm batches)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, *,
                 seed: int = 0, shard: int = 0, num_shards: int = 1):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.shard = shard
        self.num_shards = num_shards

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step * 977 + self.shard) % 2**31)
        cfg, B, S = self.cfg, self.batch, self.seq
        if cfg.family == "audio":
            return {
                "embeds": rng.randn(B, S, cfg.d_model).astype(np.float32) * 0.1,
                "targets": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
                "mask": (rng.rand(B, S) < 0.3).astype(np.float32),
            }
        if cfg.family == "vlm":
            P = cfg.prefix_tokens
            return {
                "tokens": rng.randint(0, cfg.vocab_size,
                                      (B, S - P)).astype(np.int32),
                "prefix_embeds": rng.randn(B, P, cfg.d_model)
                    .astype(np.float32) * 0.1,
            }
        return {"tokens": rng.randint(0, cfg.vocab_size, (B, S))
                .astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Depth-bounded async prefetch on the StreamPool (boostable)."""

    def __init__(self, source: SyntheticLM, *, depth: int = 2,
                 pool: Optional[StreamPool] = None, start_step: int = 0):
        self.source = source
        self.depth = depth
        self.pool = pool or StreamPool(max_active=2)
        self._q: "queue.Queue" = queue.Queue()
        self._next_submit = start_step
        self._lock = threading.Lock()
        for _ in range(depth):
            self._submit_one()

    def _submit_one(self):
        with self._lock:
            step = self._next_submit
            self._next_submit += 1
        fut = self.pool.submit(self.source.batch_at, step)
        self._q.put((step, fut))

    def boost(self, extra: int = 1):
        """Straggler-monitor hook: deepen the pipeline."""
        self.depth += extra
        for _ in range(extra):
            self._submit_one()

    def get(self):
        step, fut = self._q.get()
        batch = fut.result()
        self._submit_one()
        return step, batch
