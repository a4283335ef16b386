"""Congestion-aware rate control for one camera stream (port of
``repro.control.controller``).

AccMPEG picks *where* to spend quality (the AccModel's macroblock scores);
this module picks *how much* to spend per chunk, closing the loop against
the network the camera actually sees. The :class:`RateController` is
AIMD-shaped: one scalar quality ``level`` in [0, 1] is cut multiplicatively
when a chunk misses its delay budget (or the uplink shows backlog) and
grown additively when there is headroom. The level maps to four encode
knobs:

    qp_hi / qp_lo       the two-level QP pair (§4): higher QP, fewer bits
    alpha               the AccModel score threshold: higher, a smaller
                        high-quality area
    drop_thresh         frame-drop aggressiveness: frames whose change
                        feature falls below it are replaced by the previous
                        kept frame before encoding (a near-zero P-frame
                        residual)

Knobs travel as one float32 tensor on the policy's device
(:meth:`RateController.knob_array`), which ``_controlled_prep`` never
reads on the host: a knob change between chunks costs no synchronisation
and no new shape (the port's counterpart of the reference's "zero
recompiles"). ``observe`` reports each decision to the telemetry plane
(:mod:`repro_torch.obs`) under the reference's names.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core.quality import dilate
from repro_torch.engine.engine import jit_encode
from repro_torch.engine.policies import (QPPolicy, soft_drop_previous,
                                         warm_ready)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass(frozen=True)
class ControlKnobs:
    """One chunk's encode configuration (host-side view)."""

    alpha: float
    qp_hi: float
    qp_lo: float
    drop_thresh: float

    def as_array(self, device="cuda") -> torch.Tensor:
        """The knobs as a float32 tensor ``[alpha, qp_hi, qp_lo,
        drop_thresh]`` on ``device``. On CUDA the copy goes from pinned
        memory without blocking, so setting knobs never waits on the
        card."""
        dev = resolve_device(device)
        host = torch.tensor([self.alpha, self.qp_hi, self.qp_lo,
                             self.drop_thresh], dtype=torch.float32)
        if dev.type != "cuda":
            return host.to(dev)
        return host.pin_memory().to(dev, non_blocking=True)


@dataclasses.dataclass(frozen=True)
class ChunkObservation:
    """What the engine feeds back after each chunk.

    ``n_streams`` is how many active streams the observation covers (a
    fleet aggregates its batch), so history consumers can normalise per
    stream."""

    n_bytes: float
    stream_s: float        # transmit + RTT/2 (per-stream completion)
    queue_s: float = 0.0   # uplink-busy wait before the upload started
    compute_s: float = 0.0  # encode + camera-side model overhead
    extra_rtt_s: float = 0.0
    n_streams: int = 1

    @property
    def bytes_per_stream(self) -> float:
        return self.n_bytes / max(self.n_streams, 1)

    @property
    def total_delay_s(self) -> float:
        return self.compute_s + self.queue_s + self.stream_s \
            + self.extra_rtt_s

    @property
    def goodput_bps(self) -> float:
        """Observed uplink goodput (lower bound: includes the RTT/2)."""
        return self.n_bytes * 8.0 / max(self.stream_s, 1e-9)


def _lerp(lo: float, hi: float, x: float) -> float:
    return lo + (hi - lo) * x


class RateController:
    """AIMD controller: delay budget in, per-chunk encode knobs out.

    ``level=1`` is the richest configuration (lowest QPs, widest
    high-quality area, no frame drops); ``level=0`` the leanest. A chunk
    whose end-to-end delay exceeds ``delay_budget_s``, or that had to
    queue behind the previous chunk for more than ``backlog_tolerance`` of
    the budget, is congestion: multiplicative decrease. A chunk finishing
    under ``headroom * budget`` is room to spend: additive increase. In
    between the controller holds (hysteresis).
    """

    def __init__(self, delay_budget_s: float = 0.5,
                 qp_hi_range: Tuple[float, float] = (30.0, 42.0),
                 qp_lo_span: float = 10.0,
                 alpha_range: Tuple[float, float] = (0.25, 0.6),
                 drop_range: Tuple[float, float] = (0.0, 0.15),
                 increase_step: float = 0.10,
                 decrease_factor: float = 0.6,
                 headroom: float = 0.7,
                 backlog_tolerance: float = 0.25,
                 init_level: float = 1.0):
        self.delay_budget_s = delay_budget_s
        self.qp_hi_range = qp_hi_range
        self.qp_lo_span = qp_lo_span
        self.alpha_range = alpha_range
        self.drop_range = drop_range
        self.increase_step = increase_step
        self.decrease_factor = decrease_factor
        self.headroom = headroom
        self.backlog_tolerance = backlog_tolerance
        self.init_level = init_level
        self.reset()

    def reset(self):
        self.level = self.init_level
        self.history: List[Tuple[ControlKnobs, ChunkObservation]] = []

    # -- level -> knobs -------------------------------------------------------
    def knobs(self) -> ControlKnobs:
        x = 1.0 - self.level  # 0 = richest, 1 = leanest
        qp_hi = _lerp(self.qp_hi_range[0], self.qp_hi_range[1], x)
        return ControlKnobs(
            alpha=_lerp(self.alpha_range[0], self.alpha_range[1], x),
            qp_hi=qp_hi,
            qp_lo=min(qp_hi + self.qp_lo_span, 51.0),
            drop_thresh=_lerp(self.drop_range[0], self.drop_range[1], x),
        )

    def knob_array(self, device="cuda") -> torch.Tensor:
        return self.knobs().as_array(device)

    # -- feedback -------------------------------------------------------------
    def observe(self, obs: ChunkObservation,
                used_knobs: ControlKnobs = None) -> ControlKnobs:
        """Record the outcome of a chunk, then update the level for the
        next one. ``used_knobs`` names the knob set the chunk was encoded
        with (default: the current knobs, which is exact for the serial
        single-stream loop). Returns the new knob set."""
        self.history.append((used_knobs or self.knobs(), obs))
        budget = self.delay_budget_s
        congested = (obs.total_delay_s > budget
                     or obs.queue_s > self.backlog_tolerance * budget)
        prev = self.level
        if congested:
            self.level = max(self.level * self.decrease_factor, 0.0)
            action = "decrease"
        elif obs.total_delay_s < self.headroom * budget:
            self.level = min(self.level + self.increase_step, 1.0)
            action = "increase"
        else:
            action = "hold"
        reg = obs_metrics.get_metrics()
        if reg is not None:
            reg.counter("controller_decisions_total", action=action).inc()
            reg.gauge("controller_level").set(self.level)
        tracer = obs_trace.get_tracer()
        if tracer is not None and action != "hold":
            # level transitions only (holds would drown the lane), with
            # the observation that caused them
            tracer.instant(action, stage="controller", level=self.level,
                           prev_level=prev, delay_s=obs.total_delay_s,
                           queue_s=obs.queue_s, budget_s=budget,
                           congested=congested, n_streams=obs.n_streams)
        return self.knobs()


# ---------------------------------------------------------------------------
# the controlled policy (StreamingEngine-compatible)
# ---------------------------------------------------------------------------
def _controlled_prep(chunk, scores, knobs, *, gamma: int):
    """Knob application on the device: scores + knobs -> QP map; change
    feature + drop threshold -> effective frames
    (``engine.policies.soft_drop_previous``: dropped frames become copies
    of the previous kept frame at a fixed shape). No knob is read on the
    host, so nothing here waits on the card."""
    mask = dilate(scores[0] >= knobs[0], gamma)
    qmap = torch.where(mask, knobs[1], knobs[2])[None]
    frames_eff, keep = soft_drop_previous(chunk, knobs[3])
    return frames_eff, qmap, keep


class ControlledAccMPEGPolicy(QPPolicy):
    """AccMPEG's camera loop with the RateController in the loop: the
    AccModel still says *where* quality goes; the controller's knobs say
    how high the two QP levels are, how much area qualifies (alpha), and
    how aggressively static frames are dropped. Every chunk encodes all
    its frames (dropped ones as copies), so the encode is one chunk kernel
    launch at T = chunk size under ``fused``."""

    name = "accmpeg_controlled"

    def __init__(self, accmodel, controller: RateController,
                 gamma: int = 2):
        self.accmodel = accmodel
        self.controller = controller
        self.gamma = gamma

    def warm(self, engine, chunk):
        knobs = self.controller.knob_array(self.accmodel.device)

        def scores_prep_encode():
            scores = self.accmodel.scores(chunk[:1])
            frames_eff, qmap, _ = _controlled_prep(chunk, scores, knobs,
                                                   gamma=self.gamma)
            return jit_encode(engine.impl)(frames_eff, qmap)

        warm_ready(self.name, engine.device, scores_prep_encode)

    def encode_chunk(self, ctx):
        knobs = self.controller.knob_array(self.accmodel.device)
        scores = ctx.time_overhead(self.accmodel.scores, ctx.chunk[:1])
        frames_eff, qmap, _ = ctx.time_overhead(
            lambda: _controlled_prep(ctx.chunk, scores, knobs,
                                     gamma=self.gamma))
        return ctx.encode(qmap, frames=frames_eff)
