from .ops import lif_update, lif_update_cuda
from .ref import lif_update_ref

__all__ = ["lif_update", "lif_update_cuda", "lif_update_ref"]
