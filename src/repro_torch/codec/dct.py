"""16x16 macroblock DCT transform (port of ``repro.codec.dct``).

One orthonormal 16x16 DCT-II per macroblock, ``D @ X @ D.T``, with the
same float32 constants as the reference: the matrices are built in numpy
and cast exactly as ``repro`` builds them, so both packages quantize with
identical steps.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

MB = 16  # macroblock size (pixels)


@functools.lru_cache()
def dct_matrix(n: int = MB) -> np.ndarray:
    """Orthonormal DCT-II matrix (n x n), float64 built, float32 stored."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    d = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    d[0] /= np.sqrt(2.0)
    return d.astype(np.float32)


@functools.lru_cache()
def freq_weight(n: int = MB) -> np.ndarray:
    """Mild high-frequency quantization ramp (JPEG-flavoured), 1 .. 2."""
    k = np.arange(n, dtype=np.float32)
    w = 1.0 + (k[:, None] + k[None, :]) / (2.0 * (n - 1))
    return w.astype(np.float32)


@functools.lru_cache()
def _on_device(name: str, device: torch.device) -> torch.Tensor:
    matrix = dct_matrix() if name == "dct" else freq_weight()
    return torch.from_numpy(matrix).to(device)


def dct_tensor(device) -> torch.Tensor:
    """:func:`dct_matrix` on ``device``, copied there once (read-only)."""
    return _on_device("dct", torch.device(device))


def weight_tensor(device) -> torch.Tensor:
    """:func:`freq_weight` on ``device``, copied there once (read-only)."""
    return _on_device("weight", torch.device(device))


def blockify(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) -> (..., H/16 * W/16, C, 16, 16), macroblock-major
    with the channel inside: the ``(mb, C)`` flat order of ``repro``."""
    *lead, H, W, C = img.shape
    x = img.reshape(*lead, H // MB, MB, W // MB, MB, C)
    n = len(lead)
    x = x.permute(*range(n), n, n + 2, n + 4, n + 1, n + 3)
    return x.reshape(*lead, -1, C, MB, MB)


def unblockify(blocks: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Inverse of :func:`blockify`: (..., N, C, 16, 16) -> (..., H, W, C)."""
    *lead, _, C, _, _ = blocks.shape
    x = blocks.reshape(*lead, H // MB, W // MB, C, MB, MB)
    n = len(lead)
    x = x.permute(*range(n), n, n + 3, n + 1, n + 4, n + 2)
    return x.reshape(*lead, H, W, C)


def dct2(blocks: torch.Tensor) -> torch.Tensor:
    """blocks (..., 16, 16) -> coefficients ``D @ X @ D.T``."""
    d = dct_tensor(blocks.device)
    return d @ blocks @ d.T


def idct2(coefs: torch.Tensor) -> torch.Tensor:
    d = dct_tensor(coefs.device)
    return d.T @ coefs @ d


def qstep(qp) -> torch.Tensor:
    """H.264 quantization step for pixel range [0, 1], plain float32:
    Qstep(QP) = 0.625 * 2^((QP-4)/6) on the 8-bit scale, /255 here."""
    qp = torch.as_tensor(qp, dtype=torch.float32)
    return 0.625 * torch.exp2((qp - 4.0) / 6.0) / 255.0
