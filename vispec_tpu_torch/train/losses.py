"""Draft-distillation losses (stage 2 / ``main_mtp``, stage 1, Medusa's
SmoothL1).

  ploss = mean over masked positions of sum_v |softmax(student) - target_p|
  rloss = Plackett-Luce ranking loss over the target's top-10 token indices
  loss  = 10 * ploss + 0.1 * rloss

Everything is float32 and differentiable; the top-k indices take the JAX
package's tie order (lowest index first, ``ops.topk``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.topk import top_k


def _plackett_luce_loglik(student_logits: torch.Tensor, target_p: torch.Tensor,
                          topk: int) -> torch.Tensor:
    """Log-likelihood of the target's top-k ranking under the student's
    logits: sum_i (s_i - logsumexp(s_i..s_k)), the suffix logsumexp as a
    reversed cumulative one.  [...]."""
    _, topk_idx = top_k(target_p, topk)
    s_topk = torch.gather(student_logits, -1, topk_idx.to(torch.int64))
    log_denom = torch.flip(torch.logcumsumexp(torch.flip(s_topk, (-1,)), dim=-1), (-1,))
    return (s_topk - log_denom).sum(-1)


def _top3_metrics(metrics: dict, student_logits, target_p, mask, denom) -> dict:
    """top-1/2/3 accuracy of the student against the target's argmax."""
    tgt_tok = torch.argmax(target_p, dim=-1)
    _, top3 = top_k(student_logits, 3)
    hit = top3 == tgt_tok[..., None]
    for k in (1, 2, 3):
        name = "acc" if k == 1 else f"acc_top{k}"
        metrics[name] = (hit[..., :k].any(-1).float() * mask).sum() / denom
    return metrics


def draft_loss(
    student_logits: torch.Tensor,  # [N, S, V] float32 (N = mtp_steps + 1 stacked)
    target_p: torch.Tensor,  # [N, S, V] target softmax probabilities
    loss_mask: torch.Tensor,  # [N, S] bool/float
    topk: int = 10,
) -> Tuple[torch.Tensor, dict]:
    mask = loss_mask.float()
    denom = torch.clamp_min(mask.sum(), 1.0)

    student_p = torch.softmax(student_logits, dim=-1)
    l1 = torch.abs(student_p - target_p).sum(-1)  # [N, S]
    ploss = (l1 * mask).sum() / denom

    log_lik = _plackett_luce_loglik(student_logits, target_p, topk)
    rloss = -(log_lik * mask).sum() / denom

    loss = 10.0 * ploss + 0.1 * rloss
    metrics = {"ploss": ploss, "rloss": rloss}
    return loss, _top3_metrics(metrics, student_logits.detach(), target_p, mask, denom)


def smooth_l1(x: torch.Tensor, y: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    d = torch.abs(x - y)
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def stage1_loss(
    predict_hidden: torch.Tensor,  # [S, D] draft hidden predictions
    target_hidden: torch.Tensor,  # [S, D]
    student_logits: torch.Tensor,  # [S, V]
    target_p: torch.Tensor,  # [S, V]
    loss_mask: torch.Tensor,  # [S]
    v_w: float = 1.0,
    p_w: float = 0.1,
    topk: int = 10,
):
    """Stage-1 text-only distillation loss: SmoothL1 on hidden states +
    soft cross-entropy to the target's probabilities + top-k
    Plackett-Luce."""
    mask = loss_mask.float()
    denom = torch.clamp_min(mask.sum(), 1.0)

    vloss = (smooth_l1(predict_hidden.float(), target_hidden.float()).mean(-1)
             * mask).sum() / denom

    logp = torch.log_softmax(student_logits, dim=-1)
    ploss = -((target_p * logp).sum(-1) * mask).sum() / denom

    rloss = -(_plackett_luce_loglik(student_logits, target_p, topk) * mask).sum() / denom

    loss = v_w * vloss + p_w * ploss + 0.1 * rloss
    metrics = {"vloss": vloss, "ploss": ploss, "rloss": rloss}
    return loss, _top3_metrics(metrics, student_logits.detach(), target_p, mask, denom)
