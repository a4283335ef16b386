"""AccGrad-based quality assignment (port of ``repro.core.quality``):
threshold alpha, dilation gamma, two-level QP map."""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

DEFAULT_ALPHA = 0.2
DEFAULT_GAMMA = 5  # blocks expanded in each direction (paper default)


def select_blocks(scores: torch.Tensor, alpha: float = DEFAULT_ALPHA):
    """scores (..., mb_h, mb_w) in [0,1] -> bool mask."""
    return scores >= alpha


def dilate_scores(scores: torch.Tensor, gamma: int = DEFAULT_GAMMA):
    """Max over the (2*gamma+1)^2 window centred on each block, padded
    with -inf (SAME, stride 1). scores (..., mb_h, mb_w)."""
    if gamma <= 0:
        return scores
    lead = scores.shape[:-2]
    s = scores.reshape(-1, 1, *scores.shape[-2:])
    out = F.max_pool2d(s, 2 * gamma + 1, stride=1, padding=gamma)
    return out.reshape(*lead, *out.shape[-2:])


def dilate(mask: torch.Tensor, gamma: int = DEFAULT_GAMMA):
    """Expand selected blocks by gamma in each direction (max-pool)."""
    if gamma <= 0:
        return mask
    return dilate_scores(mask.to(torch.float32), gamma) > 0.5


@dataclasses.dataclass(frozen=True)
class QualityConfig:
    alpha: float = DEFAULT_ALPHA
    gamma: int = DEFAULT_GAMMA
    qp_hi: int = 30
    qp_lo: int = 40  # (30, 51) for keypoint per §6.1
    frame_sample: int = 10  # run AccModel once every k frames


def quality_mask(scores, cfg: QualityConfig):
    return dilate(select_blocks(scores, cfg.alpha), cfg.gamma)


def qp_map_from_scores(scores, cfg: QualityConfig):
    mask = quality_mask(scores, cfg)
    return torch.where(mask, float(cfg.qp_hi), float(cfg.qp_lo)), mask
