"""Synthetic image data (twin of ``repro.data.synthetic``, the image half):
numpy only, so its batches are bit-equal to the reference's for the same
(seed, step, shard)."""
from __future__ import annotations

import dataclasses

import numpy as np


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

