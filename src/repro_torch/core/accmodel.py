"""AccModel — the cheap camera-side quality selector (port of
``repro.core.accmodel``): a MobileNet-style feature extractor downsampling
by 16 plus three conv layers, one binary logit per 16x16 macroblock."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.vision.dnn import Conv, DwSep, to_nchw


class AccModel(nn.Module):
    """Module names follow the reference's parameter tree (``stem``,
    ``b1``..``b4``, ``c1``..``c3``)."""

    def __init__(self, width: int = 16,
                 generator: Optional[torch.Generator] = None,
                 device="cuda", name: str = "accmodel"):
        super().__init__()
        g, w = generator, width
        self.width, self.name = width, name
        self.device = resolve_device(device)
        self.stem = Conv(3, 3, w, stride=2, generator=g)     # /2
        self.b1 = DwSep(w, 2 * w, 2, g)                      # /4
        self.b2 = DwSep(2 * w, 4 * w, 2, g)                  # /8
        self.b3 = DwSep(4 * w, 8 * w, 2, g)                  # /16
        self.b4 = DwSep(8 * w, 8 * w, 1, g)                  # /16
        self.c1 = Conv(3, 8 * w, 4 * w, generator=g)
        self.c2 = Conv(3, 4 * w, 2 * w, generator=g)
        self.c3 = Conv(1, 2 * w, 1, generator=g)
        self.to(self.device)

    def forward(self, frames):
        """frames (B, H, W, 3) -> macroblock logits (B, H/16, W/16)."""
        x = F.relu(self.stem(to_nchw(frames)))
        x = self.b4(self.b3(self.b2(self.b1(x))))
        x = F.relu(self.c2(F.relu(self.c1(x))))
        return self.c3(x)[:, 0]

    @torch.no_grad()
    def scores(self, frames) -> torch.Tensor:
        """-> per-macroblock probabilities (B, mb_h, mb_w) in [0, 1]."""
        return torch.sigmoid(self(torch.as_tensor(frames,
                                                  device=self.device)))


def accmodel_flops(H: int, W: int, width: int = 16) -> float:
    """Analytic FLOPs for one frame (camera-cost accounting, Fig. 9)."""
    w = width
    f = 0.0
    h2, w2 = H // 2, W // 2
    f += h2 * w2 * 9 * 3 * w                       # stem
    dims = [(H // 4, W // 4, w, 2 * w), (H // 8, W // 8, 2 * w, 4 * w),
            (H // 16, W // 16, 4 * w, 8 * w), (H // 16, W // 16, 8 * w, 8 * w)]
    for hh, ww, ci, co in dims:
        f += hh * ww * (9 * ci + ci * co)
    hh, ww = H // 16, W // 16
    f += hh * ww * (9 * 8 * w * 4 * w + 9 * 4 * w * 2 * w + 2 * w)
    return 2.0 * f  # MAC -> FLOP
