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


def qp_maps_from_scores_batched(scores: torch.Tensor, cfg: QualityConfig):
    """scores (N, mb_h, mb_w) for N streams -> (qp_maps (N, 1, mb_h,
    mb_w), mask (N, mb_h, mb_w)). The singleton axis is the chunk's shared
    map (one AccModel call per chunk), shaped for
    ``codec.encode_chunk_batched``; dilation runs on the whole batch."""
    mask = quality_mask(scores, cfg)
    qmaps = torch.where(mask, float(cfg.qp_hi), float(cfg.qp_lo))[:, None]
    return qmaps, mask


def qp_maps_from_knobs_batched(scores: torch.Tensor, knobs: torch.Tensor,
                               gamma: int):
    """Knob-driven variant of :func:`qp_maps_from_scores_batched` for the
    rate-controlled serving path: ``knobs = [alpha, qp_hi, qp_lo, ...]``
    is a tensor on the scores' device and is never read on the host, so a
    controller can move it per chunk without a synchronisation."""
    mask = dilate(scores >= knobs[0], gamma)
    qmaps = torch.where(mask, knobs[1], knobs[2])[:, None]
    return qmaps, mask
