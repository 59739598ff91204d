"""QKFormer token attention. Only the plain version is ported; the Pallas
kernel ``qk_attention_pallas`` is still to port (ROADMAP queue 2, K8)."""
from .ref import qk_attention_ref

__all__ = ["qk_attention_ref"]
