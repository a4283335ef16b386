"""ctypes wrapper of the CUDA kernel in ``csrc/wkv6.cu``.

``wkv6_cuda`` launches one kernel per call (replaces
``repro/kernels/wkv6/kernel.py::wkv6_pallas``): over S >= 2 tokens,
``wkv6_seq_kernel`` with one thread-block cluster per (b, h) and one CTA
per segment of the sequence, as :func:`ref.segment_plan` cuts it; for a
decode step (S = 1), ``wkv6_step_kernel``, one block per (b, h). It takes
CUDA contiguous tensors (r, k, v bf16 or fp32, the rest fp32), allocates
its outputs, launches on the current stream without synchronising (so a
CUDA graph can capture it), and raises on any CUDA error the launch
reports. :data:`LAUNCHES` counts its launches, so a run can show that it
went through the kernel.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.wkv6.ref import segment_plan

#: launches per kernel: "wkv6"
LAUNCHES: collections.Counter = collections.Counter()

HEAD_DIMS = (32, 64)

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache()
def _lib():
    lib = build.load("wkv6")
    lib.wkv6.argtypes = [_P] * 8 + [_I] * 7 + [_P]
    lib.wkv6.restype = _I
    lib.wkv6_smem_bytes.argtypes = [_I, _I]
    lib.wkv6_smem_bytes.restype = _I
    return lib


def smem_bytes(hd: int, bf16: bool) -> int:
    """Dynamic shared memory of one CTA of the sequence kernel."""
    return _lib().wkv6_smem_bytes(hd, int(bf16))


def _check(r, k, v, log_decay, u, s0):
    named = (("r", r), ("k", k), ("v", v), ("log_decay", log_decay),
             ("u", u), ("s0", s0))
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != r.device:
            raise ValueError(f"{name} lies on {t.device}, r on {r.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if r.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"r must be bfloat16 or float32, got {r.dtype}")
    for name, t in named[1:3]:
        if t.dtype != r.dtype:
            raise ValueError(f"r is {r.dtype} but {name} is {t.dtype}")
    for name, t in named[3:]:
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    if r.dim() != 4:
        raise ValueError(f"expected r (B, S, H, hd), got {tuple(r.shape)}")
    B, S, H, hd = r.shape
    for name, t, shape in (("k", k, r.shape), ("v", v, r.shape),
                           ("log_decay", log_decay, r.shape),
                           ("u", u, (H, hd)), ("s0", s0, (B, H, hd, hd))):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head size {hd} not in {HEAD_DIMS}")
    if min(B, S, H) < 1:
        raise ValueError(f"empty input {tuple(r.shape)}")


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              log_decay: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """r, k, v, log_decay (B, S, H, hd); u (H, hd); s0 (B, H, hd, hd) ->
    (o (B, S, H, hd), final state (B, H, hd, hd)), fp32."""
    _check(r, k, v, log_decay, u, s0)
    B, S, H, hd = r.shape
    nseg, seg_len, _ = segment_plan(S)
    with torch.cuda.device(r.device):
        o = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
        s_out = torch.empty_like(s0)
        err = _lib().wkv6(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), log_decay.data_ptr(),
            u.data_ptr(), s0.data_ptr(), o.data_ptr(), s_out.data_ptr(),
            B, S, H, hd, int(r.dtype == torch.bfloat16), nseg, seg_len,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6 launch failed with cudaError_t {err}")
    LAUNCHES["wkv6"] += 1
    return o, s_out
