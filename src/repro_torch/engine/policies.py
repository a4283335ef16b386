"""QP policies (port of ``repro.engine.policies``): one small object per
method of the paper's comparison. A policy maps chunk state to
per-macroblock QP maps (and drives any camera-side model or server
feedback it needs); the :class:`~repro_torch.engine.engine.StreamingEngine`
owns the rest. The protocol:

    name           result label (RunResult.method)
    reset()        clear cross-chunk state before a run
    warm(engine, chunk)
                   build and launch every path the policy uses, so that
                   measured delays are steady-state
    encode_chunk(ctx) -> decoded frames the server sees
                   drive the chunk through ctx: ctx.time_overhead for
                   camera-side model cost, ctx.encode / ctx.encode_uniform
                   per transmission, ctx.add_server_rtt for feedback waits,
                   ctx.server_predict for (untimed) server inference.

Policies may hold state across chunks (EAAR's previous-chunk mask) and may
transmit more than once per chunk (DDS's two passes).

The frame-dropping policies (Reducto, SiEVE, Reducto+AccMPEG) encode a
data-dependent number of kept frames. The reference runs one untimed
encode the first time it sees a kept-frame count (``_ensure_compiled``),
to keep XLA compiles out of ``encode_s``. The port has no counterpart:
its kernels take the frame count at run time and nothing is compiled per
shape.

Box decoding, percentiles and frame-drop decisions are made on the host,
where the reference makes them; masks and gathers then go to the chunk's
device in one copy.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.codec.codec import encode_chunk_uniform, roi_qp_map
from repro_torch.codec.dct import MB
from repro_torch.core.quality import QualityConfig, dilate, qp_map_from_scores
from repro_torch.engine.engine import (ChunkContext, StreamingEngine,
                                       jit_encode, synchronize)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.vision.dnn import decode_detections


def boxes_to_mask(boxes, mb_h: int, mb_w: int, grow: int = 0,
                  device="cuda") -> torch.Tensor:
    """Pixel bounding boxes -> macroblock mask (grown by ``grow`` blocks),
    built on the host with the reference's integer arithmetic (a negative
    end index slices from the end there too), then copied to ``device``
    once."""
    m = np.zeros((mb_h, mb_w), bool)
    for (x0, y0, x1, y1, *_) in boxes:
        m[max(0, int(y0) // MB - grow): int(np.ceil(y1 / MB)) + grow,
          max(0, int(x0) // MB - grow): int(np.ceil(x1 / MB)) + grow] = True
    return torch.as_tensor(m, device=resolve_device(device))


def warm_ready(name: str, device: torch.device, *thunks):
    """Run each warm-up thunk and wait for the device; returns the last
    result. On CUDA the first call of a kernel-backed encoder builds the
    kernel library, so nvcc time stays out of every measured chunk. The
    whole warm-up is one ``warm_compile`` span on the telemetry plane's
    warmup lane, labelled with the policy's ``name``, and counts in
    ``warm_compiles_total`` / ``warmup_seconds`` (the reference's
    names)."""
    t0 = time.perf_counter()
    out = None
    for thunk in thunks:
        out = thunk()
    synchronize(device)
    dur = time.perf_counter() - t0
    tracer = obs_trace.get_tracer()
    if tracer is not None:
        tracer.complete("warm_compile", "warmup", t0, dur, policy=name,
                        n_programs=len(thunks))
    reg = obs_metrics.get_metrics()
    if reg is not None:
        reg.counter("warm_compiles_total", policy=name).inc()
        reg.histogram("warmup_seconds").observe(dur)
    return out


def frame_diff_feature(chunk: torch.Tensor) -> torch.Tensor:
    """Reducto's per-frame change feature: chunk (T, H, W, C) -> (T,), the
    first frame 1 and each later one ten times its mean absolute grey
    difference to its predecessor. (The ``0 * gx`` term is the reference's
    edge term, kept so that a non-finite frame poisons the feature as it
    does there.)"""
    gray = chunk.mean(-1)
    gx = torch.diff(gray, dim=2).abs().mean(dim=(1, 2))
    d = torch.diff(gray, dim=0).abs().mean(dim=(1, 2))
    one = torch.ones(1, dtype=d.dtype, device=d.device)
    return torch.cat([one, d * 10.0]) + 0 * gx


def soft_drop_previous(chunk: torch.Tensor, drop_thresh):
    """Frame drop at a fixed shape: frames whose change feature
    (:func:`frame_diff_feature`) falls below ``drop_thresh`` are replaced
    by the previous kept frame rather than removed, so the encode shape
    never changes (the repeated P-frame residual quantizes to ~0 bits).
    ``drop_thresh`` may be a tensor on the chunk's device, which is never
    read on the host. Frame 0 always survives. Returns (chunk, keep)."""
    T = chunk.shape[0]
    keep = frame_diff_feature(chunk) >= drop_thresh
    keep = torch.cat([torch.ones_like(keep[:1]), keep[1:]])
    idx = torch.arange(T, device=chunk.device)
    last_kept = torch.cummax(torch.where(keep, idx, -1), dim=0).values
    return chunk[last_kept], keep


def drop_static_frames(ctx: ChunkContext, feat_fn, thresh: float):
    """Reducto's temporal filter: timed frame-diff feature -> host keep
    mask (the first frame is always sent)."""
    feat = ctx.time_overhead(feat_fn, ctx.chunk)
    keep = feat.cpu().numpy() >= thresh
    keep[0] = True
    return keep


def reconstruct_dropped(decoded_kept: torch.Tensor, keep) -> torch.Tensor:
    """Server-side reuse: a dropped frame takes the last sent frame's
    decoded content (one gather on the device)."""
    idx = np.cumsum(np.asarray(keep, bool)) - 1
    return decoded_kept[torch.as_tensor(idx, device=decoded_kept.device)]


def _kept_frames(chunk: torch.Tensor, keep) -> torch.Tensor:
    return chunk[torch.as_tensor(np.flatnonzero(keep), device=chunk.device)]


class QPPolicy:
    """Base class; subclasses override encode_chunk (and usually warm)."""

    name = "policy"

    def reset(self):
        pass

    def warm(self, engine: StreamingEngine, chunk):
        pass

    def encode_chunk(self, ctx: ChunkContext):
        raise NotImplementedError


class AccMPEGPolicy(QPPolicy):
    """The paper's camera loop: AccModel once every ``frame_sample`` frames
    (default = chunk size), two-level QP map from the scores (§4).
    ``masks`` keeps each chunk's high-quality mask for inspection."""

    name = "accmpeg"

    def __init__(self, accmodel, qcfg: QualityConfig = QualityConfig(),
                 frame_sample=None):
        self.accmodel = accmodel
        self.qcfg = qcfg
        self.frame_sample = frame_sample
        self.masks = []

    def reset(self):
        self.masks = []

    def warm(self, engine, chunk):
        cs = engine.chunk_size
        k = self.frame_sample or cs
        n_maps = cs if k < cs else 1
        shape = (n_maps,) + tuple(s // MB for s in chunk.shape[1:3])
        warm_ready(
            self.name, engine.device,
            lambda: self.accmodel.scores(chunk[:1]),
            lambda: jit_encode(engine.impl)(
                chunk, torch.full(shape, 35.0, device=chunk.device)))

    def encode_chunk(self, ctx):
        chunk = ctx.chunk
        cs = ctx.engine.chunk_size
        k = self.frame_sample or cs

        def scores_fn():
            if k >= cs:
                return self.accmodel.scores(chunk[:1])
            s = self.accmodel.scores(chunk[::k])  # every k-th frame
            return s.repeat_interleave(k, dim=0)[:cs]

        scores = ctx.time_overhead(scores_fn)
        qmaps, masks = qp_map_from_scores(scores, self.qcfg)
        self.masks.append(masks)
        return ctx.encode(qmaps)


class UniformPolicy(QPPolicy):
    """AWStream-idealized building block: one uniform QP."""

    def __init__(self, qp: int, name=None):
        self.qp = qp
        self.name = name or f"uniform_qp{qp}"

    def warm(self, engine, chunk):
        warm_ready(self.name, engine.device,
                   lambda: encode_chunk_uniform(chunk, self.qp))

    def encode_chunk(self, ctx):
        return ctx.encode_uniform(self.qp)


def _server_region_mask(server, out, mb_h, mb_w, grow, det_thresh):
    """Regions of interest from a server-side inference output, as a mask
    on the server's device."""
    if server.task == "detection":
        dets = decode_detections(out, thresh=det_thresh)
        return boxes_to_mask([d for f in dets for d in f], mb_h, mb_w, grow,
                             device=server.device)
    # segmentation / keypoint: active output regions
    key = "seg" if server.task == "segmentation" else "kp"
    act = out[key].abs().amax(dim=(0, -1)).cpu().numpy()
    act = act >= np.percentile(act, 75)
    reps = mb_h // act.shape[0] + 1
    mask = np.kron(act, np.ones((reps, reps)))[:mb_h, :mb_w] > 0
    return dilate(torch.as_tensor(mask, device=server.device), grow)


def _full_qp(chunk: torch.Tensor, qp: float) -> torch.Tensor:
    """A (1, mb_h, mb_w) map of one QP on the chunk's device (warm-ups)."""
    H, W = chunk.shape[1:3]
    return torch.full((1, H // MB, W // MB), float(qp), device=chunk.device)


class DDSPolicy(QPPolicy):
    """Server-driven two-pass: low-QP pass to the server, the *final DNN*'s
    output selects regions, those re-encoded in high quality; pays both
    streams plus an extra RTT."""

    name = "dds"

    def __init__(self, qp_hi=30, qp_lo=40, grow=1):
        self.qp_hi, self.qp_lo, self.grow = qp_hi, qp_lo, grow

    def warm(self, engine, chunk):
        warm_ready(
            self.name, engine.device,
            lambda: encode_chunk_uniform(chunk, self.qp_lo),
            lambda: jit_encode(engine.impl)(chunk,
                                            _full_qp(chunk, self.qp_lo)))

    def encode_chunk(self, ctx):
        H, W = ctx.chunk.shape[1:3]
        dec1 = ctx.encode_uniform(self.qp_lo)          # pass 1: low quality
        out1 = ctx.server_predict(dec1)                # server feedback
        mask = _server_region_mask(ctx.server, out1, H // MB, W // MB,
                                   self.grow, det_thresh=0.15)
        qmap = roi_qp_map(mask, self.qp_hi, self.qp_lo)
        dec2 = ctx.encode(qmap[None])                  # pass 2: RoI redo
        ctx.add_server_rtt()                           # wait for feedback
        return dec2


class EAARPolicy(QPPolicy):
    """Previous chunk's server detections drive the current chunk's RoI
    (one chunk of staleness, no second stream)."""

    name = "eaar"

    def __init__(self, qp_hi=30, qp_lo=40, grow=2):
        self.qp_hi, self.qp_lo, self.grow = qp_hi, qp_lo, grow
        self.prev_mask = None

    def reset(self):
        self.prev_mask = None

    def warm(self, engine, chunk):
        warm_ready(self.name, engine.device,
                   lambda: jit_encode(engine.impl)(
                       chunk, _full_qp(chunk, self.qp_hi)))

    def encode_chunk(self, ctx):
        H, W = ctx.chunk.shape[1:3]
        dev = ctx.chunk.device
        mask = self.prev_mask if self.prev_mask is not None \
            else torch.ones((H // MB, W // MB), dtype=torch.bool, device=dev)
        qmap = roi_qp_map(mask, self.qp_hi, self.qp_lo)
        decoded = ctx.encode(qmap[None])
        out = ctx.server_predict(decoded)
        if ctx.server.task == "detection":
            dets = decode_detections(out, thresh=0.2)
            self.prev_mask = boxes_to_mask([d for f in dets for d in f],
                                           H // MB, W // MB, self.grow,
                                           device=dev)
        else:
            self.prev_mask = torch.ones((H // MB, W // MB),
                                        dtype=torch.bool, device=dev)
        return decoded


class ReductoPolicy(QPPolicy):
    """Camera-side frame differencing; below-threshold frames are dropped
    (the server reuses the last sent frame's result); sent frames uniform."""

    name = "reducto"

    def __init__(self, qp=32, thresh=0.05):
        self.qp, self.thresh = qp, thresh

    def warm(self, engine, chunk):
        warm_ready(self.name, engine.device,
                   lambda: frame_diff_feature(chunk),
                   lambda: encode_chunk_uniform(chunk, self.qp))

    def encode_chunk(self, ctx):
        keep = drop_static_frames(ctx, frame_diff_feature, self.thresh)
        decoded_kept = ctx.encode_uniform(
            self.qp, frames=_kept_frames(ctx.chunk, keep))
        return reconstruct_dropped(decoded_kept, keep)


def class_presence(out) -> torch.Tensor:
    """Per-frame class-presence vector from a cheap model's dense output:
    mean activation per output channel (detection heat / segmentation
    logits / keypoint channels). SiEVE's semantic filter compares these
    across frames."""
    for key in ("heat", "seg", "kp"):
        if key in out:
            return torch.sigmoid(out[key]).mean(dim=(1, 2))
    raise KeyError(f"no dense head in output (keys: {sorted(out)})")


class SiEVEPolicy(QPPolicy):
    """SiEVE-style semantic frame filtering (Elgamal et al.): a cheap
    camera-side model scores every frame's class presence, and frames
    whose presence delta against the last *sent* frame stays below
    ``delta`` are dropped; the server reuses the last sent frame's result
    (:func:`reconstruct_dropped`). Sent frames go out at one uniform QP."""

    name = "sieve"

    def __init__(self, cheap_model, qp: int = 32, delta: float = 0.02):
        self.camera = cheap_model
        self.qp = qp
        self.delta = delta

    def warm(self, engine, chunk):
        warm_ready(self.name, engine.device,
                   lambda: self.camera.predict(chunk),
                   lambda: encode_chunk_uniform(chunk, self.qp))

    def encode_chunk(self, ctx):
        def presence_fn(chunk):
            return class_presence(self.camera.predict(chunk))

        pres = ctx.time_overhead(presence_fn, ctx.chunk).cpu().numpy()
        T = ctx.chunk.shape[0]
        keep = np.zeros(T, bool)
        keep[0] = True
        last = pres[0]
        for t in range(1, T):  # delta vs last *sent* frame, not neighbour
            if np.abs(pres[t] - last).max() >= self.delta:
                keep[t] = True
                last = pres[t]
        decoded_kept = ctx.encode_uniform(
            self.qp, frames=_kept_frames(ctx.chunk, keep))
        return reconstruct_dropped(decoded_kept, keep)


class ReductoAccMPEGPolicy(QPPolicy):
    """Hybrid Reducto+AccMPEG: camera-side frame differencing drops static
    frames (the server reuses the last sent frame's result), and the kept
    frames get AccMPEG's AccModel-driven RoI encode instead of Reducto's
    uniform QP: one encode of the kept frames, so the chunk kernel runs at
    T = the number of kept frames."""

    name = "reducto_accmpeg"

    def __init__(self, accmodel, qcfg: QualityConfig = QualityConfig(),
                 thresh: float = 0.05):
        self.accmodel = accmodel
        self.qcfg = qcfg
        self.thresh = thresh

    def warm(self, engine, chunk):
        warm_ready(
            self.name, engine.device,
            lambda: frame_diff_feature(chunk),
            lambda: self.accmodel.scores(chunk[:1]),
            lambda: jit_encode(engine.impl)(chunk, _full_qp(chunk, 35.0)))

    def encode_chunk(self, ctx):
        keep = drop_static_frames(ctx, frame_diff_feature, self.thresh)
        scores = ctx.time_overhead(self.accmodel.scores, ctx.chunk[:1])
        qmap, _ = qp_map_from_scores(scores[0], self.qcfg)
        decoded_kept = ctx.encode(qmap[None],
                                  frames=_kept_frames(ctx.chunk, keep))
        return reconstruct_dropped(decoded_kept, keep)


class VigilPolicy(QPPolicy):
    """Cheap camera-side detector; bounding-box regions high quality,
    background effectively dropped (QP 51)."""

    name = "vigil"

    def __init__(self, camera_detector, qp_hi=30, qp_lo=51, grow=0):
        self.camera = camera_detector
        self.qp_hi, self.qp_lo, self.grow = qp_hi, qp_lo, grow

    def warm(self, engine, chunk):
        warm_ready(
            self.name, engine.device,
            lambda: self.camera.predict(chunk)["heat"],
            lambda: jit_encode(engine.impl)(chunk,
                                            _full_qp(chunk, self.qp_lo)))

    def encode_chunk(self, ctx):
        H, W = ctx.chunk.shape[1:3]
        out = ctx.time_overhead(self.camera.predict, ctx.chunk)  # every frame
        dets = decode_detections(out, thresh=0.25)
        mask = boxes_to_mask([d for f in dets for d in f],
                             H // MB, W // MB, self.grow,
                             device=ctx.chunk.device)
        qmap = roi_qp_map(mask, self.qp_hi, self.qp_lo)
        return ctx.encode(qmap[None])
