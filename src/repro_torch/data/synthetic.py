"""Synthetic data (twin of ``repro.data.synthetic``): a Markov bigram token
language for the LMs and class-conditional image blobs for the CNNs. Numpy
only, so the batches are bit-equal to the reference's for the same (seed,
step, shard)."""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class SyntheticTokenDataset:
    """Markov bigram language: the next token is one of ``branching``
    successors of the current one in a fixed random table, so an LM has
    structure to learn; deterministic in (seed, step, shard)."""
    vocab_size: int
    seq_len: int
    seed: int = 0
    branching: int = 8          # candidate successors per token

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.table = rng.integers(
            0, self.vocab_size, size=(self.vocab_size, self.branching))

    def batch(self, step: int, batch_size: int, shard: int = 0,
              n_shards: int = 1) -> np.ndarray:
        """[batch_size, seq_len] int32, unique per (step, shard)."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + shard * 7)
        toks = np.empty((batch_size, self.seq_len), np.int32)
        cur = rng.integers(0, self.vocab_size, size=batch_size)
        toks[:, 0] = cur
        choices = rng.integers(0, self.branching,
                               size=(batch_size, self.seq_len - 1))
        for t in range(1, self.seq_len):
            cur = self.table[cur, choices[:, t - 1]]
            toks[:, t] = cur
        return toks


@dataclasses.dataclass
class SyntheticImageDataset:
    """CIFAR-like: class-conditional Gaussian blobs plus noise, NHWC f32
    images and int32 labels; deterministic in (seed, step, shard)."""
    num_classes: int = 10
    image_size: int = 32
    channels: int = 3
    seed: int = 0
    noise: float = 0.6

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.means = rng.normal(
            0.0, 1.0, size=(self.num_classes, self.image_size,
                            self.image_size, self.channels)).astype(np.float32)

    def batch(self, step: int, batch_size: int, shard: int = 0,
              n_shards: int = 1) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + shard * 7 + 13)
        labels = rng.integers(0, self.num_classes, size=batch_size)
        imgs = self.means[labels] + rng.normal(
            0.0, self.noise, size=(batch_size, self.image_size,
                                   self.image_size, self.channels)
        ).astype(np.float32)
        return imgs.astype(np.float32), labels.astype(np.int32)



def token_batches(ds: SyntheticTokenDataset, batch_size: int,
                  start_step: int = 0, shard: int = 0,
                  n_shards: int = 1) -> Iterator[np.ndarray]:
    """``ds.batch`` of steps ``start_step``, ``start_step + 1``, ..."""
    step = start_step
    while True:
        yield ds.batch(step, batch_size, shard, n_shards)
        step += 1


def image_batches(ds: SyntheticImageDataset, batch_size: int,
                  start_step: int = 0, shard: int = 0,
                  n_shards: int = 1
                  ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """``ds.batch`` of steps ``start_step``, ``start_step + 1``, ..."""
    step = start_step
    while True:
        yield ds.batch(step, batch_size, shard, n_shards)
        step += 1
