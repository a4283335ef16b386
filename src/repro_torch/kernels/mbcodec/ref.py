"""Plain PyTorch versions of the mbcodec kernels.

They repeat the kernels' arithmetic in block space (``c / step``, the
carried reference, the per-step clip) and serve CPU tensors and the
kernel checks. ``want_q`` also returns the quantized coefficients, which
the checks use to count round-half flips between two float orders.
"""
from __future__ import annotations

import torch

from repro_torch.codec.codec import BITS_PER_MAG, BLOCK_OVERHEAD, RUN_BITS
from repro_torch.codec.dct import dct_tensor, qstep, weight_tensor


def _encode_step(src, qp, d, w):
    """One block transform: src (..., N, 16, 16), qp (..., N) ->
    (residual reconstruction, bits (..., N), q)."""
    c = d @ src @ d.T
    step = qstep(qp)[..., None, None] * w
    q = torch.round(c / step)
    aq = q.abs()
    bits = (BITS_PER_MAG * torch.log2(1.0 + aq)
            + RUN_BITS * (aq > 0.5).to(torch.float32)).sum(dim=(-2, -1)) \
        + BLOCK_OVERHEAD
    return d.T @ (q * step) @ d, bits, q


def mbcodec_ref(blocks: torch.Tensor, qp: torch.Tensor,
                want_q: bool = False):
    """blocks (N, 16, 16) f32, qp (N,) f32 -> (rec (N, 16, 16), bits (N,)),
    plus q (N, 16, 16) when ``want_q``."""
    d, w = dct_tensor(blocks.device), weight_tensor(blocks.device)
    rec, bits, q = _encode_step(blocks, qp, d, w)
    return (rec, bits, q) if want_q else (rec, bits)


def mbcodec_chunk_ref(blocks: torch.Tensor, qp: torch.Tensor,
                      clip_refs: bool = False, want_q: bool = False):
    """Block-space chunk scan: blocks (T, ..., N, 16, 16), qp (T, ..., N)
    -> (rec (T, ..., N, 16, 16), bits (T, ..., N)), plus q when
    ``want_q``.

    Frame t codes ``blocks[t] - ref`` and sets ``ref += rec`` (clipped to
    [0, 1] when ``clip_refs``); the frame-0 reference is zero."""
    d, w = dct_tensor(blocks.device), weight_tensor(blocks.device)
    ref = torch.zeros_like(blocks[0])
    recs, bits, qs = [], [], []
    for t in range(blocks.shape[0]):
        r, b, q = _encode_step(blocks[t] - ref, qp[t], d, w)
        ref = ref + r
        if clip_refs:
            ref = ref.clamp(0.0, 1.0)
        recs.append(ref)
        bits.append(b)
        qs.append(q)
    out = (torch.stack(recs), torch.stack(bits))
    return out + (torch.stack(qs),) if want_q else out


def scores_qp(pooled: torch.Tensor, knobs: torch.Tensor, C: int):
    """The QP that ``mbcodec_chunk_scores`` assigns to each block: pooled
    (S, n_mb) dilated scores and knobs (alpha, qp_hi, qp_lo) -> (S, n_mb *
    C), ``qp_hi`` where the score reaches alpha (``>=``), in the kernels'
    flat ``(mb, C)`` block order."""
    qp = torch.where(pooled >= knobs[0], knobs[1], knobs[2])
    return qp.repeat_interleave(C, dim=-1)


def mbcodec_chunk_scores_ref(blocks: torch.Tensor, pooled: torch.Tensor,
                             knobs: torch.Tensor, C: int,
                             clip_refs: bool = False, want_q: bool = False):
    """Stream-batched chunk scan with the QP thresholded from scores:
    blocks (S, T, N, 16, 16), pooled (S, N / C), knobs (3,) -> (rec (S, T,
    N, 16, 16), bits (S, T, N)), plus q when ``want_q``. Block n of
    stream s codes at :func:`scores_qp`, then runs the scan of
    :func:`mbcodec_chunk_ref`."""
    S, T, N = blocks.shape[:3]
    qp = scores_qp(pooled, knobs, C)[None].expand(T, S, N)
    out = mbcodec_chunk_ref(blocks.transpose(0, 1), qp, clip_refs, want_q)
    return tuple(t.transpose(0, 1) for t in out)
