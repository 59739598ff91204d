from .ops import (pack_spikes, pack_spikes_cuda, unpack_spikes,
                  unpack_spikes_cuda)
from .ref import pack_spikes_ref, unpack_spikes_ref, unpack_words

__all__ = ["pack_spikes", "pack_spikes_cuda", "unpack_spikes",
           "unpack_spikes_cuda", "pack_spikes_ref", "unpack_spikes_ref",
           "unpack_words"]
