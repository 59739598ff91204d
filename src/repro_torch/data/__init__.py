from .loader import ShardedLoader, shard_batch
from .synthetic import (SyntheticImageDataset, SyntheticTokenDataset,
                        image_batches, token_batches)

__all__ = ["SyntheticImageDataset", "SyntheticTokenDataset",
           "image_batches", "token_batches", "ShardedLoader", "shard_batch"]
