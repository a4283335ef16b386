"""ctypes wrapper of the CUDA kernel in ``csrc/accgrad_reduce.cu``.

``accgrad_reduce_cuda`` launches ``accgrad_reduce_kernel`` (replaces
``repro/kernels/accgrad_reduce/kernel.py::accgrad_reduce_pallas``) over a
whole batch of frames in one launch. It takes CUDA float32 contiguous
tensors, allocates its output, launches on the current stream without
synchronising, and raises on any CUDA error the launch reports.
:data:`LAUNCHES` counts its launches, so a run can show that it went
through the kernel.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.codec.dct import MB
from repro_torch.kernels import build

#: launches per kernel: "accgrad_reduce"
LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache()
def _lib():
    lib = build.load("accgrad_reduce")
    lib.accgrad_reduce.argtypes = [_P] * 4 + [_I] * 4 + [_P]
    lib.accgrad_reduce.restype = _I
    return lib


def _check(g, hq, lq):
    for name, t in (("g", g), ("hq", hq), ("lq", lq)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != tuple(g.shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(g.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != g.device:
            raise ValueError("g, hq and lq lie on different devices")
    if g.dim() != 4:
        raise ValueError(f"expected (B, H, W, C), got shape {tuple(g.shape)}")
    B, H, W, C = g.shape
    if H % MB or W % MB or min(B, H, W, C) < 1:
        raise ValueError(f"(B, H, W, C) = {tuple(g.shape)} is not a "
                         f"non-empty batch of whole {MB}x{MB} macroblocks")
    if B > 65535:  # grid.y
        raise ValueError(f"{B} frames exceed one launch's 65535")


def accgrad_reduce_cuda(g: torch.Tensor, hq: torch.Tensor,
                        lq: torch.Tensor) -> torch.Tensor:
    """g, hq, lq (B, H, W, C) -> (B, H/16, W/16): per macroblock, the sum
    of (sum_c |g|) * (sum_c |hq - lq|). One launch for the batch."""
    _check(g, hq, lq)
    B, H, W, C = g.shape
    with torch.cuda.device(g.device):
        out = torch.empty((B, H // MB, W // MB), dtype=torch.float32,
                          device=g.device)
        err = _lib().accgrad_reduce(
            g.data_ptr(), hq.data_ptr(), lq.data_ptr(), out.data_ptr(),
            B, H, W, C, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"accgrad_reduce launch failed with cudaError_t "
                           f"{err}")
    LAUNCHES["accgrad_reduce"] += 1
    return out
