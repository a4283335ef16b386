"""ctypes wrappers of the CUDA kernel in ``csrc/mbcodec.cu``.

The file holds one kernel template, ``mbcodec_chunk_kernel<clip_refs,
QpSource>``, behind three entry points. ``mbcodec_chunk_cuda`` launches it
with ``QpFromArray`` (replaces ``repro/kernels/mbcodec/kernel.py::
mbcodec_chunk_pallas``), ``mbcodec_chunk_scores_cuda`` with
``QpFromScores`` over a whole fleet chunk (replaces
``mbcodec_chunk_scores_pallas`` under the reference's ``jax.vmap``) and
``mbcodec_frame_cuda`` with ``QpFromArray`` at T = 1 and no clip (replaces
``mbcodec_pallas``; bit for bit ``mbcodec_chunk_cuda`` at T = 1). All take
CUDA float32 contiguous tensors, allocate their outputs, launch on the
current stream without synchronising, and raise on any CUDA error the
launch reports. The kernel reads each block row as 16-byte vectors, so
every wrapper also refuses a ``blocks`` that does not start on a 16-byte
boundary. It holds D compiled in (each transform FMA takes it as an
immediate), and each launch checks it against ``codec/dct.py``'s; w goes
into the launch's parameters from host memory, so a captured CUDA graph
holds it. :data:`LAUNCHES` counts the launches of each entry point, so a
run can show that it went through them.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.codec.dct import MB, dct_matrix, freq_weight
from repro_torch.kernels import build

#: launches per kernel: "mbcodec_frame", "mbcodec_chunk[clip=False|True]",
#: "mbcodec_chunk_scores[clip=False|True]"
LAUNCHES: collections.Counter = collections.Counter()

#: what every entry point returns when the host's D differs from the one
#: compiled into the kernel (``kDctMismatch`` in ``mbcodec.cu``)
DCT_MISMATCH = -1

_P = ctypes.c_void_p
_I = ctypes.c_int


def chunk_kernel_name(clip_refs: bool) -> str:
    return f"mbcodec_chunk[clip={bool(clip_refs)}]"


def scores_kernel_name(clip_refs: bool) -> str:
    return f"mbcodec_chunk_scores[clip={bool(clip_refs)}]"


@functools.lru_cache()
def _lib():
    lib = build.load("mbcodec")
    lib.mbcodec_chunk.argtypes = [_P] * 7 + [_I, _I, _I, _P]
    lib.mbcodec_chunk.restype = _I
    lib.mbcodec_chunk_scores.argtypes = [_P] * 8 + [_I] * 6 + [_P]
    lib.mbcodec_chunk_scores.restype = _I
    lib.mbcodec_frame.argtypes = [_P] * 7 + [_I, _P]
    lib.mbcodec_frame.restype = _I
    return lib


def _check(name, t, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_aligned(**tensors):
    for name, t in tensors.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def _host_consts():
    """Host pointers to D and w (float32, kept alive by the caches of
    ``codec/dct.py``): each launch checks D against the D the kernel was
    compiled with and takes w as a launch parameter."""
    return dct_matrix().ctypes.data, freq_weight().ctypes.data


def _raise_on(err: int, kernel: str):
    if err == DCT_MISMATCH:
        raise RuntimeError(f"{kernel}: the D compiled into mbcodec.cu is not "
                           f"codec/dct.py's dct_matrix()")
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with cudaError_t {err}")


def mbcodec_chunk_cuda(blocks: torch.Tensor, qp: torch.Tensor,
                       clip_refs: bool = False, want_q: bool = False):
    """blocks (T, N, 16, 16), qp (T, N) -> (rec (T, N, 16, 16), bits (T, N)),
    plus the quantized coefficients (T, N, 16, 16) when ``want_q``."""
    T, N = blocks.shape[:2]
    _check("blocks", blocks, (T, N, MB, MB))
    _check("qp", qp, (T, N))
    if T < 1 or N < 1:
        raise ValueError(f"empty chunk: T={T}, N={N}")
    if qp.device != blocks.device:
        raise ValueError("blocks and qp lie on different devices")
    _check_aligned(blocks=blocks)
    with torch.cuda.device(blocks.device):
        d, w = _host_consts()
        rec = torch.empty_like(blocks)
        bits = torch.empty((T, N), dtype=torch.float32, device=blocks.device)
        q = torch.empty_like(blocks) if want_q else None
        _check_aligned(rec=rec, q=q)
        err = _lib().mbcodec_chunk(
            blocks.data_ptr(), qp.data_ptr(), d, w,
            rec.data_ptr(), bits.data_ptr(), q.data_ptr() if want_q else None,
            T, N, int(bool(clip_refs)),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, chunk_kernel_name(clip_refs))
    LAUNCHES[chunk_kernel_name(clip_refs)] += 1
    return (rec, bits, q) if want_q else (rec, bits)


def mbcodec_chunk_scores_cuda(blocks: torch.Tensor, pooled: torch.Tensor,
                              knobs: torch.Tensor, C: int,
                              clip_refs: bool = False, want_q: bool = False):
    """blocks (S, T, N, 16, 16) for S streams, pooled (S, N / C) dilated
    scores, knobs (3,) = (alpha, qp_hi, qp_lo) -> (rec (S, T, N, 16, 16),
    bits (S, T, N)), plus q (S, T, N, 16, 16) when ``want_q``. One launch
    for the whole fleet chunk; the kernel reads the knobs from the card."""
    S, T, N = blocks.shape[:3]
    if C < 1 or N % C:
        raise ValueError(f"{N} blocks are not whole macroblocks of {C} "
                         f"channels")
    n_mb = N // C
    _check("blocks", blocks, (S, T, N, MB, MB))
    _check("pooled", pooled, (S, n_mb))
    _check("knobs", knobs, (3,))
    if S < 1 or T < 1 or N < 1:
        raise ValueError(f"empty fleet chunk: S={S}, T={T}, N={N}")
    if S > 65535:  # grid.y
        raise ValueError(f"{S} streams exceed one launch's 65535")
    if pooled.device != blocks.device or knobs.device != blocks.device:
        raise ValueError("blocks, pooled and knobs lie on different devices")
    _check_aligned(blocks=blocks)
    name = scores_kernel_name(clip_refs)
    with torch.cuda.device(blocks.device):
        d, w = _host_consts()
        rec = torch.empty_like(blocks)
        bits = torch.empty((S, T, N), dtype=torch.float32,
                           device=blocks.device)
        q = torch.empty_like(blocks) if want_q else None
        _check_aligned(rec=rec, q=q)
        err = _lib().mbcodec_chunk_scores(
            blocks.data_ptr(), pooled.data_ptr(), knobs.data_ptr(),
            d, w, rec.data_ptr(), bits.data_ptr(),
            q.data_ptr() if want_q else None, S, T, N, n_mb, C,
            int(bool(clip_refs)), torch.cuda.current_stream().cuda_stream)
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return (rec, bits, q) if want_q else (rec, bits)


def mbcodec_frame_cuda(blocks: torch.Tensor, qp: torch.Tensor,
                       want_q: bool = False):
    """blocks (N, 16, 16), qp (N,) -> (rec (N, 16, 16), bits (N,)), plus q
    (N, 16, 16) when ``want_q``: the chunk kernel at T = 1 with no clip."""
    N = blocks.shape[0]
    _check("blocks", blocks, (N, MB, MB))
    _check("qp", qp, (N,))
    if N < 1:
        raise ValueError("empty frame")
    if qp.device != blocks.device:
        raise ValueError("blocks and qp lie on different devices")
    _check_aligned(blocks=blocks)
    with torch.cuda.device(blocks.device):
        d, w = _host_consts()
        rec = torch.empty_like(blocks)
        bits = torch.empty((N,), dtype=torch.float32, device=blocks.device)
        q = torch.empty_like(blocks) if want_q else None
        _check_aligned(rec=rec, q=q)
        err = _lib().mbcodec_frame(
            blocks.data_ptr(), qp.data_ptr(), d, w,
            rec.data_ptr(), bits.data_ptr(), q.data_ptr() if want_q else None,
            N, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "mbcodec_frame")
    LAUNCHES["mbcodec_frame"] += 1
    return (rec, bits, q) if want_q else (rec, bits)
