"""Plain versions of the pack and unpack kernels: the PyTorch pack and
unpack of ``core.events`` (kept there so ``core`` needs no kernel).

``pack_spikes_ref(x, with_occ=True)`` is the pack kernel's function on the
same [..., M, K] input: padded words, ``vld_cnt`` and ``occ``.
``unpack_words(words)`` is the unpack kernel's: the padded dense map.
"""
from __future__ import annotations

from ...core.events import (PackedSpikes, pack_spikes_ref, unpack_spikes_ref,
                            unpack_words)

__all__ = ["PackedSpikes", "pack_spikes_ref", "unpack_spikes_ref",
           "unpack_words"]
