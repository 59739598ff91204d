"""Knowledge-distillation losses (twin of ``repro.core.kd``): the logit KD
the paper's CNN pipeline trains with (C1), temperature-scaled KL to the
teacher plus cross-entropy to the labels, and its token-level form for
distilling a spiking LM from its softmax twin (``sequence_kd_loss``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class KDConfig:
    temperature: float = 4.0
    alpha: float = 0.7          # weight on the KD (KL) term; (1-alpha) on CE
    feature_beta: float = 0.0   # optional hidden-state MSE term


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[..., None].long())[..., 0]
    return nll.mean()


def kl_divergence(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                  temperature: float) -> torch.Tensor:
    """KL(teacher || student) with temperature scaling, scaled by T^2 so the
    gradient magnitude does not depend on T (Hinton et al.)."""
    t = temperature
    p_t = torch.softmax(teacher_logits / t, dim=-1)
    logp_t = torch.log_softmax(teacher_logits / t, dim=-1)
    logp_s = torch.log_softmax(student_logits / t, dim=-1)
    kl = (p_t * (logp_t - logp_s)).sum(dim=-1)
    return kl.mean() * (t * t)


def kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
            labels: torch.Tensor, cfg: KDConfig = KDConfig(),
            student_feats=None, teacher_feats=None
            ) -> tuple[torch.Tensor, dict]:
    """Returns (loss, {"ce", "kl", "loss"[, "feature_mse"]}); the teacher's
    side passes no gradient."""
    ce = softmax_cross_entropy(student_logits, labels)
    kl = kl_divergence(student_logits, teacher_logits.detach(),
                       cfg.temperature)
    loss = (1.0 - cfg.alpha) * ce + cfg.alpha * kl
    metrics = {"ce": ce, "kl": kl}
    if cfg.feature_beta > 0.0 and student_feats is not None:
        fmse = ((student_feats - teacher_feats.detach()) ** 2).mean()
        loss = loss + cfg.feature_beta * fmse
        metrics["feature_mse"] = fmse
    metrics["loss"] = loss
    return loss, metrics


def sequence_kd_loss(student_logits: torch.Tensor,
                     teacher_logits: torch.Tensor, tokens: torch.Tensor,
                     cfg: KDConfig = KDConfig(),
                     mask: Optional[torch.Tensor] = None
                     ) -> tuple[torch.Tensor, dict]:
    """Token-level KD for LM distillation: ``student_logits`` and
    ``teacher_logits`` [B, S, V], ``tokens`` [B, S] the targets. ``mask``
    [B, S] weights the cross-entropy's tokens (a mean over the unmasked
    ones); the KL term takes every token. Returns (loss, {"ce", "kl",
    "loss"}); the teacher's side passes no gradient."""
    b, s, v = student_logits.shape
    sl = student_logits.reshape(b * s, v)
    tl = teacher_logits.reshape(b * s, v)
    lab = tokens.reshape(b * s)
    if mask is not None:
        m = mask.reshape(b * s).to(sl.dtype)
        logp = torch.log_softmax(sl, dim=-1)
        picked = logp.gather(-1, lab[:, None].long())[:, 0]
        ce = -(picked * m).sum() / torch.clamp(m.sum(), min=1.0)
    else:
        ce = softmax_cross_entropy(sl, lab)
    kl = kl_divergence(sl, tl.detach(), cfg.temperature)
    loss = (1.0 - cfg.alpha) * ce + cfg.alpha * kl
    return loss, {"ce": ce, "kl": kl, "loss": loss}


def make_distill_loss_fn(student_apply: Callable, teacher_apply: Callable,
                         teacher_params, cfg: KDConfig = KDConfig()
                         ) -> Callable:
    """``loss_fn(student_params, batch) -> (loss, metrics)`` with ``batch``
    = {"inputs", "labels"}: the logit KD of the student against the
    teacher, which runs without autograd on the parameters closed over."""

    def loss_fn(student_params, batch):
        s_logits = student_apply(student_params, batch["inputs"])
        with torch.no_grad():
            t_logits = teacher_apply(teacher_params, batch["inputs"])
        return kd_loss(s_logits, t_logits, batch["labels"], cfg)

    return loss_fn
