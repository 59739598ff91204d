"""Knowledge-distillation loss (twin of ``repro.core.kd``, the logit KD the
paper's CNN pipeline trains with, C1): temperature-scaled KL to the
teacher plus cross-entropy to the labels.
"""
from __future__ import annotations

import dataclasses

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
