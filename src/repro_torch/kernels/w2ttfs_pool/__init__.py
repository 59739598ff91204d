from .ops import w2ttfs_pool_cuda, w2ttfs_pool_fc
from .ref import w2ttfs_pool_fc_ref

__all__ = ["w2ttfs_pool_cuda", "w2ttfs_pool_fc", "w2ttfs_pool_fc_ref"]
