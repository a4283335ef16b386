"""Macroblock RoI codec (port of ``repro.codec.codec``).

    encode_frame(frame, qp_map)          -> (decoded, bits_map)
    encode_chunk(frames, qp_maps)        -> (decoded, per_frame_bytes)

The byte model is the reference's entropy proxy over quantized
coefficients. Functions run on whatever device their tensors lie on;
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.codec.dct import (MB, blockify, dct2, idct2, qstep,
                                   unblockify, weight_tensor)

BITS_PER_MAG = 1.7  # bits per log2(1+|q|)
RUN_BITS = 0.9      # per-nonzero positional cost
BLOCK_OVERHEAD = 10.0  # per-macroblock header bits


def _quantize(coefs, qp):
    """coefs (..., C, 16, 16); qp broadcastable to (...,)."""
    step = qstep(qp).to(coefs.device)[..., None, None, None] \
        * weight_tensor(coefs.device)
    return torch.round(coefs / step), step


def block_bits(q: torch.Tensor) -> torch.Tensor:
    """Entropy-proxy bits per macroblock. q: (..., C, 16, 16) -> (...,)."""
    aq = q.abs()
    mag = torch.log2(1.0 + aq)
    nonzero = (aq > 0.5).to(torch.float32)
    return (BITS_PER_MAG * mag + RUN_BITS * nonzero).sum(dim=(-3, -2, -1)) \
        + BLOCK_OVERHEAD


def encode_frame(frame: torch.Tensor, qp_map: torch.Tensor,
                 reference: Optional[torch.Tensor] = None):
    """Encode one frame (H, W, C) float32 in [0,1] against ``reference``
    (the previous *decoded* frame; None -> I-frame). qp_map (H/16, W/16).
    Returns (decoded (H,W,C), bits_map (H/16, W/16))."""
    H, W, C = frame.shape
    src = frame if reference is None else frame - reference
    coefs = dct2(blockify(src))  # (N, C, 16, 16)
    q, step = _quantize(coefs, qp_map.reshape(-1))
    rec = unblockify(idct2(q * step), H, W)
    if reference is not None:
        rec = rec + reference
    return rec.clamp(0.0, 1.0), block_bits(q).reshape(H // MB, W // MB)


def _scan_chunk(encode_one, frames: torch.Tensor, qp_maps: torch.Tensor):
    """Shared I-frame + P-frame scan: ``encode_one(frame, qmap, reference)``
    codes one frame (reference=None -> I-frame)."""
    T = frames.shape[0]
    qp_maps = qp_maps.expand((T,) + qp_maps.shape[1:]) \
        if qp_maps.shape[0] == 1 else qp_maps
    decs, all_bytes, prev = [], [], None
    for t in range(T):
        prev, bits = encode_one(frames[t], qp_maps[t], prev)
        decs.append(prev)
        all_bytes.append(bits.sum() / 8.0)
    return torch.stack(decs), torch.stack(all_bytes)


def encode_chunk(frames: torch.Tensor, qp_maps: torch.Tensor):
    """frames (T, H, W, C); qp_maps (T or 1, H/16, W/16). First frame is an
    I-frame, the rest are P-frames against the decoded predecessor.
    Returns (decoded (T,H,W,C), per_frame_bytes (T,))."""
    return _scan_chunk(
        lambda f, q, ref: encode_frame(f, q, reference=ref), frames, qp_maps)


def encode_chunk_uniform(frames: torch.Tensor, qp: int):
    T, H, W, _ = frames.shape
    qmap = torch.full((1, H // MB, W // MB), float(qp), device=frames.device)
    return encode_chunk(frames, qmap)


def roi_qp_map(mask: torch.Tensor, qp_hi: float, qp_lo: float):
    """mask (mb_h, mb_w) bool -> QP map."""
    return torch.where(mask, float(qp_hi), float(qp_lo))


def encode_chunk_fast(frames: torch.Tensor, qp_maps: torch.Tensor,
                      clip_correct: bool = False):
    """Coefficient-space equivalent of :func:`encode_chunk`.

    The P-frame recursion runs on DCT coefficients: all forward
    transforms are hoisted before the scan and (without ``clip_correct``)
    all inverse transforms after it; the [0, 1] clip is applied once at
    decode time. ``clip_correct=True`` folds every step's pixel-space clip
    back into the coefficient state (``rec += dct2(clip(pix) - pix)``).
    The correction is applied unconditionally (it is exactly zero on
    in-gamut steps), as the reference's vmapped form computes it, so no
    step waits on the host to test whether a frame left gamut.
    """
    T, H, W, _ = frames.shape
    if qp_maps.shape[0] == 1:
        qp_maps = qp_maps.expand((T,) + qp_maps.shape[1:])
    steps = qstep(qp_maps.reshape(T, -1)).to(frames.device)[
        :, :, None, None, None] * weight_tensor(frames.device)
    rsteps = 1.0 / steps
    coefs = dct2(blockify(frames))  # (T, N, C, 16, 16)
    rec = torch.zeros_like(coefs[0])

    if not clip_correct:
        recs = []
        for t in range(T):
            q = torch.round((coefs[t] - rec) * rsteps[t])
            rec = rec + q * steps[t]
            recs.append(rec)
        recs = torch.stack(recs)
        qs = torch.diff(recs, dim=0,
                        prepend=torch.zeros_like(recs[:1])) * rsteps
        decoded = unblockify(idct2(recs), H, W)
        return decoded.clamp(0.0, 1.0), block_bits(qs).sum(-1) / 8.0

    pix_all, qs = [], []
    for t in range(T):
        q = torch.round((coefs[t] - rec) * rsteps[t])
        rec = rec + q * steps[t]
        pix = idct2(rec)
        delta = pix.clamp(0.0, 1.0) - pix
        rec = rec + dct2(delta)
        pix_all.append(pix + delta)
        qs.append(q)
    pbytes = block_bits(torch.stack(qs)).sum(-1) / 8.0
    return unblockify(torch.stack(pix_all), H, W), pbytes


# ---------------------------------------------------------------------------
# chunk-encoder backend registry
# ---------------------------------------------------------------------------
class ChunkEncoderRegistry:
    """Named chunk-encoder backends behind the serving path's ``impl=``
    knob. Every backend maps ``(frames (T, H, W, C), qp_maps (T or 1,
    H/16, W/16))`` to ``(decoded (T, H, W, C), per_frame_bytes (T,))``.
    Names are write-once; an unknown name raises ``ValueError``."""

    def __init__(self):
        self._backends = {}

    def register(self, name: str, fn=None):
        """Register ``fn`` under ``name`` (usable as a decorator)."""
        def _add(f):
            if name in self._backends:
                raise ValueError(f"chunk encoder {name!r} already registered")
            self._backends[name] = f
            return f
        return _add(fn) if fn is not None else _add

    def resolve(self, name: str):
        try:
            return self._backends[name]
        except KeyError:
            raise ValueError(
                f"unknown chunk encoder {name!r}; registered backends: "
                f"{', '.join(sorted(self._backends))}") from None

    def __getitem__(self, name: str):
        return self.resolve(name)

    def __contains__(self, name: str) -> bool:
        return name in self._backends

    def __len__(self) -> int:
        return len(self._backends)

    def names(self):
        return sorted(self._backends)


CHUNK_ENCODERS = ChunkEncoderRegistry()
CHUNK_ENCODERS.register("exact", encode_chunk)
CHUNK_ENCODERS.register("fast", encode_chunk_fast)
CHUNK_ENCODERS.register(
    "fast_exact", functools.partial(encode_chunk_fast, clip_correct=True))


@CHUNK_ENCODERS.register("pallas")
def encode_chunk_pallas(frames: torch.Tensor, qp_maps: torch.Tensor):
    """Per frame, ``kernels.mbcodec.ops.encode_frame_fused`` codes the
    residual against the previous decoded frame (``mbcodec_frame`` kernel
    on CUDA, its plain version on CPU); same scan as ``exact``."""
    from repro_torch.kernels.mbcodec.ops import encode_frame_fused

    return _scan_chunk(
        lambda f, q, ref: encode_frame_fused(f, q, reference=ref),
        frames, qp_maps)


@CHUNK_ENCODERS.register("fused")
def encode_chunk_fused_backend(frames: torch.Tensor, qp_maps: torch.Tensor):
    """One ``mbcodec_chunk`` launch encodes the whole chunk with the
    decoded reference carried inside each thread block; the [0, 1] clip
    is applied once at decode time, as ``fast`` does."""
    from repro_torch.kernels.mbcodec.ops import encode_chunk_fused

    return encode_chunk_fused(frames, qp_maps)


@CHUNK_ENCODERS.register("fused_exact")
def encode_chunk_fused_exact_backend(frames: torch.Tensor,
                                     qp_maps: torch.Tensor):
    """``fused`` with the reference clipped to [0, 1] every step: the
    exact encoder's semantics."""
    from repro_torch.kernels.mbcodec.ops import encode_chunk_fused

    return encode_chunk_fused(frames, qp_maps, clip_refs=True)


# ---------------------------------------------------------------------------
# batched leading-axis entry points (N independent streams)
# ---------------------------------------------------------------------------
def encode_chunk_batched(frames: torch.Tensor, qp_maps: torch.Tensor,
                         impl: str = "exact"):
    """frames (N, T, H, W, C); qp_maps (N, T or 1, H/16, W/16) ->
    (decoded (N, T, H, W, C), bytes (N, T)).

    The counterpart of the reference's ``jax.vmap`` over streams:
    ``CHUNK_ENCODERS[impl]`` codes each stream's chunk in turn, so every
    stream gets exactly its single-stream result. (The fleet's ``fused``
    backends do not come here: they take one stream-batched kernel
    launch, ``kernels.mbcodec.ops.encode_chunk_fused_scores_batched``.)"""
    enc = CHUNK_ENCODERS.resolve(impl)
    outs = [enc(f, q) for f, q in zip(frames, qp_maps)]
    return (torch.stack([d for d, _ in outs]),
            torch.stack([b for _, b in outs]))


def encode_chunk_uniform_batched(frames: torch.Tensor, qp: int,
                                 impl: str = "exact"):
    """Uniform-QP variant of :func:`encode_chunk_batched`."""
    N, _, H, W, _ = frames.shape
    qmaps = torch.full((N, 1, H // MB, W // MB), float(qp),
                       device=frames.device)
    return encode_chunk_batched(frames, qmaps, impl)
