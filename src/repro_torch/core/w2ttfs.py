"""W2TTFS classifier head (twin of ``repro.core.w2ttfs``).

The TTFS filter counts the spikes of each pooling window; NEURAL's WTFC
replaces the position-dependent ``t / window^2`` scale by the unit scale
``1 / window^2`` applied once per counted spike, so the head is
``logits = (counts @ fc_w) * (1 / window^2) + fc_b`` (what the deployed
models run). ``w2ttfs_reference`` is Algorithm 1 written out (the one-hot
time expansion of ``w2ttfs_expand``) and ``w2ttfs_time_reuse`` the
hardware's replay of the unit accumulation; the tests hold the forms
equal. Layout: NHWC.
"""
from __future__ import annotations

import torch


def window_counts(spike_map: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, H//window, W//window, C] spike counts."""
    b, h, w, c = spike_map.shape
    ho, wo = h // window, w // window
    return spike_map.reshape(b, ho, window, wo, window, c).sum(dim=(2, 4))


def w2ttfs_expand(spike_map: torch.Tensor, window: int) -> torch.Tensor:
    """Algorithm 1's one-hot spike train over window^2 + 1 virtual steps:
    [T, B, Ho, Wo, C], slice t firing where the window's count is t."""
    cnt = window_counts(spike_map, window)
    t_axis = torch.arange(window * window + 1, device=spike_map.device)
    return (cnt[None] == t_axis.reshape(-1, 1, 1, 1, 1)).to(spike_map.dtype)


def w2ttfs_reference(spike_map: torch.Tensor, fc_w: torch.Tensor,
                     fc_b: torch.Tensor, window: int) -> torch.Tensor:
    """Algorithm 1 verbatim: at virtual step t the FC weights scale by
    ``t / window^2``, and the logits sum over the steps."""
    expanded = w2ttfs_expand(spike_map, window)
    t, b = expanded.shape[0], expanded.shape[1]
    flat = expanded.reshape(t, b, -1)
    scales = torch.arange(t, dtype=fc_w.dtype,
                          device=fc_w.device) / float(window * window)
    acc = torch.zeros((b, fc_w.shape[1]), dtype=fc_w.dtype,
                      device=fc_w.device)
    for spikes_t, scale_t in zip(flat, scales):
        acc = acc + (spikes_t @ fc_w) * scale_t
    return acc + fc_b


def w2ttfs_time_reuse(spike_map: torch.Tensor, fc_w: torch.Tensor,
                      fc_b: torch.Tensor, window: int) -> torch.Tensor:
    """The time-reuse datapath: at micro-step u the FC accumulates ``unit *
    [count > u]``, the unit contribution replayed count times a window."""
    cnt = window_counts(spike_map, window)
    flat_cnt = cnt.reshape(cnt.shape[0], -1)
    unit = 1.0 / float(window * window)
    acc = torch.zeros((cnt.shape[0], fc_w.shape[1]), dtype=fc_w.dtype,
                      device=fc_w.device)
    for u in range(window * window):
        # the deployed head's window thresholds, never differentiated  # neurallint: disable=NL-BARE-HEAVISIDE
        acc = acc + ((flat_cnt > u).to(fc_w.dtype) @ fc_w) * unit
    return acc + fc_b


def w2ttfs_classifier(spike_map: torch.Tensor, fc_w: torch.Tensor,
                      fc_b: torch.Tensor, window: int) -> torch.Tensor:
    """The WTFC head: window counts times the unit-scale FC.
    ``fc_w``: [Ho*Wo*C, classes]."""
    cnt = window_counts(spike_map, window).to(fc_w.dtype)
    unit = 1.0 / float(window * window)
    return (cnt.reshape(cnt.shape[0], -1) @ fc_w) * unit + fc_b


def avgpool_classifier(x: torch.Tensor, fc_w: torch.Tensor,
                       fc_b: torch.Tensor, window: int) -> torch.Tensor:
    """The ANN head W2TTFS replaces: average pooling, then the FC."""
    b, h, w, c = x.shape
    ho, wo = h // window, w // window
    pooled = x.reshape(b, ho, window, wo, window, c).mean(dim=(2, 4))
    return pooled.reshape(b, -1).to(fc_w.dtype) @ fc_w + fc_b
