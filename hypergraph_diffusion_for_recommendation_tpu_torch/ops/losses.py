"""Training losses — the port of the JAX package's `ops/losses.py`, keeping
the reference's quirks (util/loss_torch.py): `bpr_loss` adds 1e-5 inside
the log (:5-9) and `l2_reg_loss` sums UN-squared L2 norms (:17-21). Only
the TransR KG losses use `log_sigmoid` (`transr_kg_loss`, models/khgrec.py,
models/kgat.py).
"""

from __future__ import annotations

import torch


def bpr_loss(user_emb: torch.Tensor, pos_emb: torch.Tensor, neg_emb: torch.Tensor) -> torch.Tensor:
    """-log(1e-5 + sigmoid(pos - neg)), mean (the reference's `10e-6`)."""
    pos_score = torch.sum(user_emb * pos_emb, dim=1)
    neg_score = torch.sum(user_emb * neg_emb, dim=1)
    return -torch.mean(torch.log(1e-5 + torch.sigmoid(pos_score - neg_score)))


def triplet_loss(user_emb: torch.Tensor, pos_emb: torch.Tensor,
                 neg_emb: torch.Tensor) -> torch.Tensor:
    """Hinge triplet, margin 1 (util/loss_torch.py:11-15)."""
    pos_score = torch.sum(user_emb * pos_emb, dim=1)
    neg_score = torch.sum(user_emb * neg_emb, dim=1)
    return torch.mean(torch.relu(neg_score + 1.0 - pos_score))


def l2_reg_loss(reg: float, *embs: torch.Tensor) -> torch.Tensor:
    """reg * sum_i ||E_i||_2, NOT squared; +1e-24 under the square root
    keeps the gradient finite at zero."""
    total = 0.0
    for e in embs:
        total = total + torch.sqrt(torch.sum(torch.square(e)) + 1e-24)
    return reg * total


def l2_reg_loss_sq(reg: float, *embs: torch.Tensor) -> torch.Tensor:
    """reg * sum_i ||E_i||_2^2, the conventional squared form (SHT's
    calcRegLoss, SHT.py:236)."""
    total = 0.0
    for e in embs:
        total = total + torch.sum(torch.square(e))
    return reg * total


def l2_loss_mean(x: torch.Tensor) -> torch.Tensor:
    """TransR regulariser: the mean of each row's sum of squares over 2
    (util/loss_torch.py:112-113)."""
    return torch.mean(torch.sum(torch.square(x), dim=1) / 2.0)


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """torch `F.normalize(p=2, dim=-1)` written as x * rsqrt(max(sum_sq,
    eps^2)), as the JAX package does, so the gradient at x == 0 is zero."""
    sq = torch.sum(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps * eps))


def contrast_loss(embeds1: torch.Tensor, embeds2: torch.Tensor, nodes: torch.Tensor,
                  temp: float) -> torch.Tensor:
    """HCCF-style contrastive loss over picked nodes (util/loss_torch.py:
    103-110): rows +1e-8 shifted, then row-normalised, as the reference.
    `nodes` may repeat; callers pass de-duplicated ids (the reference's
    torch.unique)."""
    e1 = _l2_normalize(embeds1 + 1e-8)
    e2 = _l2_normalize(embeds2 + 1e-8)
    p1 = e1[nodes.long()]
    p2 = e2[nodes.long()]
    nume = torch.exp(torch.sum(p1 * p2, dim=-1) / temp)
    deno = torch.sum(torch.exp(p1 @ p2.T / temp), dim=-1) + 1e-8
    return -torch.mean(torch.log(nume / deno))


def contrast_loss_masked(embeds1: torch.Tensor, embeds2: torch.Tensor, nodes: torch.Tensor,
                         valid: torch.Tensor, temp: float) -> torch.Tensor:
    """`contrast_loss` over a fixed-size node buffer with a validity mask
    (duplicates masked off): masked rows leave both the mean and the
    denominator's contrast set."""
    e1 = _l2_normalize(embeds1 + 1e-8)
    e2 = _l2_normalize(embeds2 + 1e-8)
    return _masked_contrast(e1[nodes.long()], e2[nodes.long()], valid, temp)


def _masked_contrast(p1, p2, valid, temp):
    nume = torch.exp(torch.sum(p1 * p2, dim=-1) / temp)
    logits = p1 @ p2.T / temp
    expd = torch.exp(logits) * valid[None, :].to(logits.dtype)
    deno = torch.sum(expd, dim=-1) + 1e-8
    per = -torch.log(nume / deno)
    vf = valid.to(per.dtype)
    return torch.sum(per * vf) / torch.clamp(torch.sum(vf), min=1.0)


def contrast_loss_pregathered(p1_raw: torch.Tensor, p2_raw: torch.Tensor, valid: torch.Tensor,
                              temp: float) -> torch.Tensor:
    """HCCF-style contrastive loss (util/loss_torch.py:103-110) over
    pre-gathered rows with a validity mask: rows are +1e-8 shifted and
    row-normalised; masked rows leave both the mean and the denominator's
    contrast set."""
    return _masked_contrast(_l2_normalize(p1_raw + 1e-8), _l2_normalize(p2_raw + 1e-8),
                            valid, temp)


def info_nce(view1: torch.Tensor, view2: torch.Tensor, temperature: float,
             b_cos: bool = True) -> torch.Tensor:
    """InfoNCE over paired rows (util/loss_torch.py:32-40): +1e-5 inside
    the log, as the reference."""
    if b_cos:
        view1, view2 = _l2_normalize(view1), _l2_normalize(view2)
    pos_score = torch.exp(torch.sum(view1 * view2, dim=-1) / temperature)
    ttl_score = torch.sum(torch.exp(view1 @ view2.T / temperature), dim=1)
    return -torch.mean(torch.log(pos_score / ttl_score + 1e-5))


def batch_softmax_loss(user_emb: torch.Tensor, item_emb: torch.Tensor,
                       temperature: float) -> torch.Tensor:
    """In-batch softmax over the batch's items (util/loss_torch.py:23-30)."""
    return info_nce(user_emb, item_emb, temperature, b_cos=True)


def info_nce_masked(view1: torch.Tensor, view2: torch.Tensor, valid: torch.Tensor,
                    temperature: float) -> torch.Tensor:
    """`info_nce` over a fixed-size buffer of picked rows with a validity
    mask (the static-shape form of torch.unique picks): masked rows leave
    both the mean and the denominator's contrast set."""
    v1, v2 = _l2_normalize(view1), _l2_normalize(view2)
    pos_score = torch.exp(torch.sum(v1 * v2, dim=-1) / temperature)
    logits = torch.exp(v1 @ v2.T / temperature) * valid[None, :].to(view1.dtype)
    ttl = torch.sum(logits, dim=1)
    per = -torch.log(pos_score / ttl + 1e-5)
    vf = valid.to(per.dtype)
    return torch.sum(per * vf) / torch.clamp(torch.sum(vf), min=1.0)


def unique_mask(ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Static-shape `torch.unique`: sorted ids and a first-occurrence mask."""
    s = torch.sort(ids).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    return s, first


def kl_divergence(p_logit: torch.Tensor, q_logit: torch.Tensor) -> torch.Tensor:
    """util/loss_torch.py:43-46."""
    p = torch.softmax(p_logit, dim=-1)
    kl = torch.sum(p * (torch.log_softmax(p_logit, dim=-1) - torch.log_softmax(q_logit, dim=-1)),
                   dim=1)
    return torch.mean(kl)


def js_divergence(p_logit: torch.Tensor, q_logit: torch.Tensor) -> torch.Tensor:
    """util/loss_torch.py:48-53."""
    return kl_divergence(p_logit, q_logit) + kl_divergence(q_logit, p_logit)


def transr_kg_loss(h_emb: torch.Tensor, r_emb: torch.Tensor, w_r: torch.Tensor,
                   pos_t_emb: torch.Tensor, neg_t_emb: torch.Tensor, reg_kg: float,
                   batch_size_kg: int) -> torch.Tensor:
    """TransR-style KG loss (reference KHGRec.py:347-365 / KGAT.py:305-330),
    w_r the per-triple projection [B, d, dr] gathered by relation id:
    mean(-logsigmoid(||h+r-t_neg||^2 - ||h+r-t_pos||^2)) plus
    l2_reg_loss(reg_kg, the projections) / batch_size_kg."""
    r_mul_h = torch.einsum("bd,bdr->br", h_emb, w_r)
    r_mul_pos = torch.einsum("bd,bdr->br", pos_t_emb, w_r)
    r_mul_neg = torch.einsum("bd,bdr->br", neg_t_emb, w_r)
    pos_score = torch.sum(torch.square(r_mul_h + r_emb - r_mul_pos), dim=1)
    neg_score = torch.sum(torch.square(r_mul_h + r_emb - r_mul_neg), dim=1)
    kg_loss = torch.mean(-torch.nn.functional.logsigmoid(neg_score - pos_score))
    reg = l2_reg_loss(reg_kg, r_mul_h, r_emb, r_mul_pos, r_mul_neg) / batch_size_kg
    return kg_loss + reg
