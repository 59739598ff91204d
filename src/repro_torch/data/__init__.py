from .synthetic import (SyntheticImageDataset, SyntheticTokenDataset,
                        image_batches, token_batches)

__all__ = ["SyntheticImageDataset", "SyntheticTokenDataset",
           "image_batches", "token_batches"]
