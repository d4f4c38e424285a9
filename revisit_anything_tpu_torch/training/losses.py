"""Metric-learning losses: MultiSimilarity loss and miner, contrastive,
triplet margin and NT-Xent.

Counterpart of ``revisit_anything_tpu/training/losses.py`` (the
pytorch_metric_learning configurations VLAD-BuFF trains with), as the
same mask-based, fixed-shape forms. Each takes f32 embeddings [B, D] and
integer place labels [B] and is differentiable by autograd; the
similarity products run in true f32.
"""

from __future__ import annotations

from typing import Tuple

import torch

from revisit_anything_tpu_torch.ops.knn import f32_products
from revisit_anything_tpu_torch.ops.vlad import l2_normalize

_NEG_INF = -1e30


def _pair_masks(labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos_mask, neg_mask) [B, B]: same-label pairs without self, and
    different-label pairs."""
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(labels.shape[0], dtype=torch.bool, device=labels.device)
    return same & ~eye, ~same


def _gram(emb: torch.Tensor) -> torch.Tensor:
    with f32_products():
        return emb @ emb.T


def multi_similarity_miner_mask(embeddings: torch.Tensor,
                                labels: torch.Tensor,
                                epsilon: float = 0.1
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MultiSimilarityMiner: per anchor, the positives with cos < max_neg
    + eps and the negatives with cos > min_pos − eps."""
    cos = _gram(l2_normalize(embeddings, 1))
    pos_mask, neg_mask = _pair_masks(labels)
    max_neg = torch.where(neg_mask, cos, _NEG_INF).amax(1)
    min_pos = torch.where(pos_mask, cos, -_NEG_INF).amin(1)
    keep_pos = pos_mask & (cos < (max_neg + epsilon)[:, None])
    keep_neg = neg_mask & (cos > (min_pos - epsilon)[:, None])
    return keep_pos, keep_neg


def multi_similarity_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                          alpha: float = 1.0, beta: float = 50.0,
                          base: float = 0.0, use_miner: bool = True,
                          miner_epsilon: float = 0.1) -> torch.Tensor:
    """MS loss over dot-product similarities of the L2-normalized
    embeddings, averaged over ALL anchors (zero-loss anchors stay in the
    denominator, pytorch_metric_learning's MeanReducer). The miner's
    masks carry no gradient."""
    embeddings = l2_normalize(embeddings, 1)
    sims = _gram(embeddings)
    if use_miner:
        with torch.no_grad():
            pos_mask, neg_mask = multi_similarity_miner_mask(
                embeddings, labels, miner_epsilon)
    else:
        pos_mask, neg_mask = _pair_masks(labels)
    zero = sims.new_zeros(())
    pos_exp = torch.where(pos_mask, torch.exp(-alpha * (sims - base)), zero)
    neg_exp = torch.where(neg_mask, torch.exp(beta * (sims - base)), zero)
    pos_loss = torch.log1p(pos_exp.sum(1)) / alpha
    neg_loss = torch.log1p(neg_exp.sum(1)) / beta
    return torch.mean(pos_loss + neg_loss)


def _pairwise_l2(embeddings: torch.Tensor) -> torch.Tensor:
    sq = (embeddings ** 2).sum(1)
    d2 = sq[:, None] + sq[None, :] - 2 * _gram(embeddings)
    return torch.sqrt(torch.clamp(d2, min=1e-12))


def contrastive_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                     pos_margin: float = 0.0,
                     neg_margin: float = 1.0) -> torch.Tensor:
    """Contrastive loss over L2 distances of the normalized embeddings:
    positives pay max(d − pos_m, 0), negatives max(neg_m − d, 0), each
    set averaged over its non-zero terms, the two means summed."""
    dist = _pairwise_l2(l2_normalize(embeddings, 1))
    pos_mask, neg_mask = _pair_masks(labels)
    zero = dist.new_zeros(())
    pos_term = torch.where(pos_mask, torch.clamp(dist - pos_margin, min=0.0),
                           zero)
    neg_term = torch.where(neg_mask, torch.clamp(neg_margin - dist, min=0.0),
                           zero)
    pos_mean = pos_term.sum() / torch.clamp((pos_term > 0).sum(), min=1)
    neg_mean = neg_term.sum() / torch.clamp((neg_term > 0).sum(), min=1)
    return pos_mean + neg_mean


def triplet_margin_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                        margin: float = 0.1) -> torch.Tensor:
    """Batch-all triplet margin loss over L2 distances of the normalized
    embeddings, averaged over the violating triplets."""
    dist = _pairwise_l2(l2_normalize(embeddings, 1))
    pos_mask, neg_mask = _pair_masks(labels)
    viol = dist[:, :, None] - dist[:, None, :] + margin
    valid = pos_mask[:, :, None] & neg_mask[:, None, :]
    viol = torch.where(valid, torch.clamp(viol, min=0.0), viol.new_zeros(()))
    return viol.sum() / torch.clamp((viol > 0).sum(), min=1)


def ntxent_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                temperature: float = 0.07) -> torch.Tensor:
    """NT-Xent over cosine similarities: per positive pair, −log of its
    softmax against that anchor's negatives."""
    sims = _gram(l2_normalize(embeddings, 1)) / temperature
    pos_mask, neg_mask = _pair_masks(labels)
    zero = sims.new_zeros(())
    neg_exp = torch.where(neg_mask, torch.exp(sims), zero).sum(1)
    denom = torch.exp(sims) + neg_exp[:, None]
    per_pair = torch.where(pos_mask, -(sims - torch.log(denom)), zero)
    return per_pair.sum() / torch.clamp(pos_mask.sum(), min=1)


def get_loss(name: str):
    """The loss by VLAD-BuFF's ``utils/losses.py`` name."""
    table = {
        "MultiSimilarityLoss": multi_similarity_loss,
        "ContrastiveLoss": contrastive_loss,
        "TripletMarginLoss": triplet_margin_loss,
        "NTXentLoss": ntxent_loss,
    }
    try:
        return table[name]
    except KeyError:
        raise NotImplementedError(
            f"loss {name!r} not implemented; available: {sorted(table)}")
