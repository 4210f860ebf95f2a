"""Deterministic synthetic data, a copy of the JAX package's
``repro.data.pipeline`` (numpy only): ``DataConfig`` and ``TokenBatches``
(the training stream and the prompts of the static batch path when no
shared prefix is asked for), ``CifarBatches`` (the CNN zoo's images) and
``make_batches``.

No datasets ship with the repository, so the pipeline synthesizes a
Zipf-distributed integer LM stream with short-range Markov structure,
pre-shifted into (inputs, targets) pairs, deterministically from (seed,
step, rank): ``batch(step)`` is a pure function, and each data-parallel
rank draws a disjoint slice.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab_size: int = 256
    seq_len: int = 64
    global_batch: int = 8
    n_codebooks: int = 0          # musicgen-style multi-stream tokens
    zipf_a: float = 1.3
    markov_strength: float = 0.7  # P(next = f(prev)) — learnable structure


class TokenBatches:
    """Synthetic LM token stream."""

    def __init__(self, cfg: DataConfig, rank: int = 0, world: int = 1):
        if cfg.global_batch % world:
            raise ValueError("global_batch must divide by world size")
        self.cfg = cfg
        self.rank = rank
        self.world = world
        self.local_batch = cfg.global_batch // world
        # fixed random permutation = the Markov successor function
        rng = np.random.default_rng(cfg.seed)
        self._succ = rng.permutation(cfg.vocab_size)
        # Zipf-ish marginal over the vocab
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._marginal = p / p.sum()

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 7919 + self.rank)
        shape = (self.local_batch, cfg.seq_len + 1)
        if cfg.n_codebooks:
            shape = shape + (cfg.n_codebooks,)
        toks = rng.choice(cfg.vocab_size, size=shape, p=self._marginal)
        # inject Markov structure along the sequence axis
        follow = rng.random(shape[:2]) < cfg.markov_strength
        for t in range(1, cfg.seq_len + 1):
            prev = toks[:, t - 1]
            toks[:, t] = np.where(follow[:, t][..., None] if cfg.n_codebooks
                                  else follow[:, t],
                                  self._succ[prev], toks[:, t])
        toks = toks.astype(np.int32)
        return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class CifarBatches:
    """Class-conditional Gaussian 32x32x3 images, 10 classes (CIFAR stand-in
    for the paper's CNN-zoo benchmarks)."""

    def __init__(self, seed: int = 0, batch: int = 128, n_classes: int = 10):
        self.seed = seed
        self.batch = batch
        self.n_classes = n_classes
        rng = np.random.default_rng(seed)
        # one low-frequency template per class
        base = rng.normal(size=(n_classes, 8, 8, 3)).astype(np.float32)
        self._templates = np.repeat(np.repeat(base, 4, axis=1), 4, axis=2)

    def batch_at(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(self.seed * 99991 + step)
        labels = rng.integers(0, self.n_classes, size=self.batch)
        noise = rng.normal(scale=0.8, size=(self.batch, 32, 32, 3))
        images = self._templates[labels] + noise.astype(np.float32)
        return images.astype(np.float32), labels.astype(np.int32)

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_batches(cfg: DataConfig, n_steps: int, rank: int = 0,
                 world: int = 1) -> list[dict[str, np.ndarray]]:
    src = TokenBatches(cfg, rank, world)
    return [src.batch(i) for i in range(n_steps)]
