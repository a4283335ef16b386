"""Public entry points of the fused macroblock codec.

Each dispatches on the device of its tensors: a CUDA tensor launches the
hand-written kernel (``kernel.py``), which either runs or raises; a CPU
tensor takes the plain PyTorch version (``ref.py``). The wrappers own the
blockify / per-channel layout, so callers never see the kernels' flat
``(mb, C)`` block order.
"""
from __future__ import annotations

import torch

from repro_torch.codec.codec import BLOCK_OVERHEAD
from repro_torch.codec.dct import MB, blockify, unblockify
from repro_torch.kernels import on_cuda
from repro_torch.kernels.mbcodec.kernel import (mbcodec_chunk_cuda,
                                                mbcodec_chunk_scores_cuda,
                                                mbcodec_frame_cuda)
from repro_torch.kernels.mbcodec.ref import (mbcodec_chunk_ref,
                                             mbcodec_chunk_scores_ref,
                                             mbcodec_ref)


def _on_cuda(t: torch.Tensor) -> bool:
    return on_cuda(t, "mbcodec")


def mbcodec(blocks: torch.Tensor, qp: torch.Tensor):
    """blocks (N, 16, 16), qp (N,) -> (rec, bits)."""
    if _on_cuda(blocks):
        return mbcodec_frame_cuda(blocks.contiguous(), qp.contiguous())
    return mbcodec_ref(blocks, qp)


def mbcodec_chunk(blocks: torch.Tensor, qp: torch.Tensor,
                  clip_refs: bool = False):
    """blocks (T, N, 16, 16), qp (T, N) -> (rec, bits)."""
    if _on_cuda(blocks):
        return mbcodec_chunk_cuda(blocks.contiguous(), qp.contiguous(),
                                  clip_refs)
    return mbcodec_chunk_ref(blocks, qp, clip_refs)


def mbcodec_chunk_scores(blocks: torch.Tensor, pooled: torch.Tensor,
                         knobs: torch.Tensor, C: int,
                         clip_refs: bool = False):
    """blocks (S, T, N, 16, 16), pooled (S, N / C), knobs (3,) -> (rec,
    bits (S, T, N))."""
    if _on_cuda(blocks):
        return mbcodec_chunk_scores_cuda(
            blocks.contiguous(), pooled.contiguous(),
            knobs.to(torch.float32).contiguous(), C, clip_refs)
    return mbcodec_chunk_scores_ref(blocks, pooled, knobs, C, clip_refs)


def encode_frame_fused(frame: torch.Tensor, qp_map: torch.Tensor,
                       reference: torch.Tensor = None):
    """Kernel-backed equivalent of ``codec.encode_frame``: frame (H, W, C),
    qp_map (H/16, W/16) -> (decoded, bits_map); ``reference`` is the
    previous *decoded* frame (None -> I-frame)."""
    H, W, C = frame.shape
    src = frame if reference is None else frame - reference
    blocks = blockify(src).reshape(-1, MB, MB)  # (N*C, 16, 16)
    qp = qp_map.reshape(-1).to(torch.float32).repeat_interleave(C)
    rec, bits = mbcodec(blocks, qp)
    rec = unblockify(rec.reshape(-1, C, MB, MB), H, W)
    if reference is not None:
        rec = rec + reference
    # one per-macroblock header, not one per channel (as codec.block_bits)
    bits_map = bits.reshape(-1, C).sum(-1) - (C - 1) * BLOCK_OVERHEAD
    return rec.clamp(0.0, 1.0), bits_map.reshape(H // MB, W // MB)


def _chunk_blocks(frames: torch.Tensor):
    """frames (..., T, H, W, C) -> flat per-channel blocks (..., T,
    n_mb*C, 16, 16), plus n_mb and C. Each kernel thread block owns one
    whole block, so unlike the TPU tiles nothing is padded."""
    blocks = blockify(frames)  # (..., T, n_mb, C, 16, 16)
    n_mb, C = blocks.shape[-4:-2]
    return blocks.reshape(*blocks.shape[:-4], n_mb * C, MB, MB), n_mb, C


def _chunk_finish(rec, bits, n_mb, C, H, W, clip_refs):
    """Kernel outputs (..., T, n_mb*C, ...) -> (decoded (..., T, H, W, C),
    bytes (..., T)). Channel bits re-merge to one header per macroblock:
    the kernels charge ``BLOCK_OVERHEAD`` once per channel block."""
    lead = bits.shape[:-1]
    bits_mb = bits.reshape(*lead, n_mb, C).sum(-1) - (C - 1) * BLOCK_OVERHEAD
    decoded = unblockify(rec.reshape(*lead, n_mb, C, MB, MB), H, W)
    if not clip_refs:  # the clipped path already clipped every reference
        decoded = decoded.clamp(0.0, 1.0)
    return decoded, bits_mb.sum(-1) / 8.0


def encode_chunk_fused(frames: torch.Tensor, qp_maps: torch.Tensor,
                       clip_refs: bool = False):
    """Chunk-fused equivalent of ``codec.encode_chunk`` (``clip_refs``) /
    ``encode_chunk_fast``: frames (T, H, W, C), qp_maps (T or 1, H/16,
    W/16) -> (decoded (T, H, W, C), per_frame_bytes (T,)). On CUDA this
    is one ``mbcodec_chunk`` launch for the whole chunk."""
    T, H, W, _ = frames.shape
    blocks, n_mb, C = _chunk_blocks(frames)
    qp = qp_maps.reshape(qp_maps.shape[0], -1).to(torch.float32)
    qp = qp.expand(T, n_mb).repeat_interleave(C, dim=1)  # (mb, C) flat
    rec, bits = mbcodec_chunk(blocks, qp, clip_refs)
    return _chunk_finish(rec, bits, n_mb, C, H, W, clip_refs)


def encode_chunk_fused_scores_batched(frames: torch.Tensor,
                                      pooled: torch.Tensor,
                                      knobs: torch.Tensor,
                                      clip_refs: bool = False):
    """Scores-path chunk encode of a whole fleet, QP assignment fused into
    the kernel: frames (N, T, H, W, C), pooled (N, H/16, W/16) *dilated*
    AccModel scores (``quality.dilate_scores``), knobs (alpha, qp_hi,
    qp_lo, ...) on the frames' device -> (decoded (N, T, H, W, C), bytes
    (N, T)). On CUDA this is one ``mbcodec_chunk_scores`` launch for all N
    streams; the knobs are read on the card, never on the host. Because
    max-pooling commutes with monotone thresholding, ``pooled >= alpha``
    in the kernel is the dilate-then-select QP map, which never exists in
    device memory. Unlike the reference, nothing is padded: block n reads
    its macroblock's score at ``n // C``."""
    H, W = frames.shape[2:4]
    blocks, n_mb, C = _chunk_blocks(frames)
    rec, bits = mbcodec_chunk_scores(blocks, pooled.reshape(-1, n_mb),
                                     knobs[:3], C, clip_refs)
    return _chunk_finish(rec, bits, n_mb, C, H, W, clip_refs)


def encode_chunk_fused_scores(frames: torch.Tensor, pooled: torch.Tensor,
                              knobs: torch.Tensor, clip_refs: bool = False):
    """One stream of :func:`encode_chunk_fused_scores_batched`: frames (T,
    H, W, C), pooled (H/16, W/16) -> (decoded (T, H, W, C), bytes (T,))."""
    decoded, pbytes = encode_chunk_fused_scores_batched(
        frames[None], pooled[None], knobs, clip_refs)
    return decoded[0], pbytes[0]
