"""Deterministic synthetic data pipelines (shard-aware, prefetching).

No ImageNet on box — these generate statistically-plausible stand-ins
with a *learnable* signal (labels derive from the inputs) so training
loops demonstrably reduce loss.  Sharding: each data-parallel rank draws
a disjoint, deterministic slice keyed by (seed, rank, step) — elastic
restarts replay exactly.

The port's own copy of ``repro.data.pipeline`` (numpy only): the same
``RandomState`` keys, so every batch is the reference's, bit for bit.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np

__all__ = ["TokenPipeline", "ImagePipeline", "LatentPipeline", "Prefetcher"]


@dataclasses.dataclass
class TokenPipeline:
    """Synthetic LM corpus: order-2 Markov chain over the vocab, so there
    is real next-token structure to learn."""
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    rank: int = 0
    world: int = 1

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        self._trans = rng.dirichlet(np.ones(min(self.vocab, 64)) * 0.1,
                                    size=min(self.vocab, 64))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step * self.world + self.rank)
            % (2 ** 31))
        v = self._trans.shape[0]
        toks = np.zeros((self.batch, self.seq_len + 1), np.int32)
        toks[:, 0] = rng.randint(0, v, self.batch)
        for t in range(1, self.seq_len + 1):
            p = self._trans[toks[:, t - 1] % v]
            c = (p.cumsum(-1) > rng.rand(self.batch)[:, None]).argmax(-1)
            toks[:, t] = c
        toks = toks % self.vocab
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclasses.dataclass
class ImagePipeline:
    """Synthetic classification: class-conditional Gaussian blobs."""
    img_res: int
    batch: int
    n_classes: int = 10
    seed: int = 0
    rank: int = 0
    world: int = 1

    def __post_init__(self):
        rng = np.random.RandomState(self.seed + 7)
        self._proto = rng.randn(self.n_classes, 8, 8, 3).astype(np.float32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(
            (self.seed * 999_983 + step * self.world + self.rank) % (2 ** 31))
        labels = rng.randint(0, self.n_classes, self.batch).astype(np.int32)
        base = self._proto[labels]
        reps = self.img_res // 8 + 1
        img = np.tile(base, (1, reps, reps, 1))[:, :self.img_res,
                                                :self.img_res]
        img = img + 0.3 * rng.randn(*img.shape).astype(np.float32)
        return {"image": img.astype(np.float32), "label": labels}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclasses.dataclass
class LatentPipeline:
    """Synthetic diffusion latents + conditioning."""
    latent_res: int
    channels: int
    batch: int
    ctx_len: int = 77
    ctx_dim: int = 768
    seed: int = 0
    rank: int = 0
    world: int = 1

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(
            (self.seed * 424_243 + step * self.world + self.rank) % (2 ** 31))
        lat = rng.randn(self.batch, self.latent_res, self.latent_res,
                        self.channels).astype(np.float32)
        ctx = rng.randn(self.batch, self.ctx_len,
                        self.ctx_dim).astype(np.float32)
        return {"latent": lat, "ctx": ctx}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of a pipeline iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def work():
            for item in it:
                if self._stop.is_set():
                    return
                self._q.put(item)

        self._t = threading.Thread(target=work, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
