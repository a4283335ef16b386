"""Fleet autoscaling from measured stage occupancy (port of
``repro.control.autoscaler``: numpy over the port's ``FleetTiming`` and
``obs``).

``MultiStreamEngine`` measures what each serving stage actually costs per
chunk interval (``core.pipeline.FleetTiming``: fused camera step, batched
server DNN, host accounting, and the loop's wall clock). The
:class:`FleetAutoscaler` turns those measurements into deployment
decisions — the ROADMAP's open "server-side autoscaling" item:

- **stream-mesh width**: when the camera stage saturates the wall clock,
  shard the stream axis wider; when everything idles, narrow. The port
  serves on one card until the multi-GPU slice (ROADMAP module 8), so
  :meth:`FleetAutoscaler.decide` counts one usable device unless the
  caller passes ``n_devices`` and never proposes a wider mesh here.
- **server batch depth**: when the server stage dominates, deepen the
  double buffer (more chunks in flight hide server latency behind camera
  encode); ``depth=1`` is the serialized loop.

Admission control (:meth:`FleetAutoscaler.admit`) handles stream
joins/leaves: the engine warms its fleet steps once per (N, T, H, W, C)
shape (on the card the first call at a shape also pays cuDNN's algorithm
search), so serving N±1 streams naively would warm up again every chunk
the fleet churns.
Instead the active streams are padded up to a bucketed shape (multiples of
the mesh width, rounded to powers of two) and shapes already compiled are
reused while the padding waste stays bounded (``reuse_slack``) — churn
costs device idle lanes, and at most O(log N) warm-ups ever.

``CrossHostAutoscaler`` comes with the multi-host slice (ROADMAP module
8).

``ChurnEvent`` / :func:`apply_churn` are the schedule vocabulary the
closed serving loop (``MultiStreamEngine.serve_loop``) consumes: streams
join and leave at chunk boundaries, admission re-pads mid-stream, and
``ScaleDecision``s apply between chunks without tearing the engine down.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.pipeline import FleetTiming
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

#: the cards a scale-out can claim: the engine serves on one until the
#: multi-GPU slice (ROADMAP module 8) brings the stream mesh
USABLE_DEVICES = 1


@dataclasses.dataclass(frozen=True)
class ChurnEvent:
    """A stream-membership change at a chunk-interval boundary.

    ``chunk`` names the interval *before* which the event applies: streams
    in ``join`` start serving at that interval, streams in ``leave`` stop.
    Stream ids index the fleet's frame array (``serve_loop``'s leading
    axis), so a camera that leaves and later rejoins keeps its identity —
    and its per-stream accounting picks up where it left off.
    """

    chunk: int
    join: Tuple[int, ...] = ()
    leave: Tuple[int, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "join", tuple(self.join))
        object.__setattr__(self, "leave", tuple(self.leave))
        if self.chunk < 0:
            raise ValueError("churn events happen at chunk >= 0")
        if set(self.join) & set(self.leave):
            raise ValueError("a stream cannot join and leave in one event")


def apply_churn(active: Sequence[int], events: Sequence[ChurnEvent],
                ci: int) -> list:
    """Fold the events scheduled for interval ``ci`` into ``active``
    (join order preserved — lane assignment stays deterministic)."""
    ids = list(active)
    for ev in events:
        if ev.chunk != ci:
            continue
        for sid in ev.leave:
            if sid not in ids:
                raise ValueError(f"stream {sid} leaves at chunk {ci} but "
                                 f"is not active")
            ids.remove(sid)
        for sid in ev.join:
            if sid in ids:
                raise ValueError(f"stream {sid} joins at chunk {ci} but "
                                 f"is already active")
            ids.append(sid)
    return ids


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    """What the fleet should look like for the next serving interval.

    ``tenant_share`` (multi-tenant fleets only) is the capacity split:
    tenant t's fraction of the fleet's serving lanes for the next
    interval, proportional to its occupancy. ``None`` on fleets without
    tenants."""

    mesh_width: int
    batch_depth: int  # chunks in flight; 1 = serialized, >=2 = overlapped
    reason: str
    tenant_share: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if self.tenant_share is not None:
            object.__setattr__(self, "tenant_share",
                               tuple(float(x) for x in self.tenant_share))

    @property
    def overlap(self) -> bool:
        return self.batch_depth >= 2


@dataclasses.dataclass(frozen=True)
class AdmissionPlan:
    """Padded fleet shape for the current set of active streams."""

    n_active: int
    n_padded: int
    active: np.ndarray  # (n_padded,) bool — which lanes carry real streams
    reused: bool        # True if a previously compiled shape was reused


def stage_occupancy(timing: FleetTiming) -> Dict[str, float]:
    """Fraction of the loop's wall clock each stage kept busy. With
    overlap the fractions can sum past 1 — that is the pipelining.

    A zero (or unset) makespan — the first chunk of a closed-loop run,
    before any interval has been measured — reports all-zero occupancy
    instead of dividing by epsilon: occupancies in the millions would
    read as a camera-bound fleet and trigger a bogus scale-out."""
    wall = timing.wall_s
    if wall <= 0.0:
        return {"camera": 0.0, "server": 0.0, "host": 0.0}
    return {
        "camera": float(np.sum(timing.camera_s)) / wall,
        "server": float(np.sum(timing.server_s)) / wall,
        "host": float(np.sum(timing.host_s)) / wall,
    }


class FleetAutoscaler:
    """Occupancy-driven mesh-width / batch-depth policy + admission.

    ``target_occupancy`` is the busy fraction above which a stage counts
    as the bottleneck; below ``idle_fraction`` the fleet is
    over-provisioned and scales back in. Decisions are deliberately
    single-step (one knob notch per interval) — the same damping argument
    as AIMD: occupancy measurements are noisy, and a fleet that jumps to
    the "optimal" width on one sample oscillates.
    """

    def __init__(self, target_occupancy: float = 0.8,
                 idle_fraction: float = 0.4,
                 min_depth: int = 1, max_depth: int = 4,
                 pad_pow2: bool = True, reuse_slack: float = 2.0):
        self.target_occupancy = target_occupancy
        self.idle_fraction = idle_fraction
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.pad_pow2 = pad_pow2
        #: how much bigger than the tight padded shape an already-compiled
        #: shape may be and still be reused (2.0 = at most one pow2 bucket
        #: up, so at most half the lanes idle; 1.0 = always run the tight
        #: shape, compile-greedy but compute-optimal). Either way the
        #: shape set stays O(log N): only tight pow2 buckets are ever
        #: *added*, the slack only governs reuse.
        self.reuse_slack = reuse_slack
        self._compiled_shapes: Set[int] = set()

    @property
    def compiled_shapes(self) -> Tuple[int, ...]:
        """Every padded fleet shape admitted so far (sorted). The churn
        acceptance bound: stays O(log N_max) per mesh width used. (The
        reference's name: the port compiles nothing per shape, and a shape
        here is one the engine warms up once.)"""
        return tuple(sorted(self._compiled_shapes))

    # -- scaling --------------------------------------------------------------
    def decide(self, timing: FleetTiming, n_streams: int,
               mesh_width: int = 1, batch_depth: int = 2,
               n_devices: Optional[int] = None,
               tenant_streams: Optional[Sequence[int]] = None,
               ) -> ScaleDecision:
        """Pick the next (mesh_width, batch_depth) from measured timing.
        One record point for the telemetry plane: every decision — from
        any of the policy's exit paths, and from a subclass via
        ``super().decide`` — lands here exactly once.

        ``tenant_streams`` (multi-tenant fleets): per-tenant active stream
        counts for the interval; the decision then carries
        ``tenant_share``, each tenant's fraction of the serving lanes in
        proportion to its occupancy (0.0 for a tenant with no active
        stream)."""
        d = self._decide(timing, n_streams, mesh_width=mesh_width,
                         batch_depth=batch_depth, n_devices=n_devices)
        if tenant_streams is not None:
            counts = np.asarray(list(tenant_streams), np.float64)
            total = float(counts.sum())
            share = tuple(counts / total) if total > 0 else \
                tuple(0.0 for _ in counts)
            d = dataclasses.replace(d, tenant_share=share)
        changed = (d.mesh_width, d.batch_depth) != (mesh_width, batch_depth)
        reg = obs_metrics.get_metrics()
        if reg is not None:
            reg.counter("scale_decisions_total",
                        action="rescale" if changed else "hold").inc()
        tracer = obs_trace.get_tracer()
        if tracer is not None and changed:
            tracer.instant("scale", stage="autoscaler",
                           mesh_width=d.mesh_width,
                           batch_depth=d.batch_depth,
                           prev_width=mesh_width, prev_depth=batch_depth,
                           n_streams=n_streams, reason=d.reason)
        return d

    def _decide(self, timing: FleetTiming, n_streams: int,
                mesh_width: int = 1, batch_depth: int = 2,
                n_devices: Optional[int] = None) -> ScaleDecision:
        if n_devices is None:
            n_devices = USABLE_DEVICES
        occ = stage_occupancy(timing)
        bottleneck = max(occ, key=occ.get)
        if occ[bottleneck] <= 0.0:
            # nothing measured yet (first chunk / zero makespan): hold —
            # an all-zero occupancy would otherwise read as "idle" and
            # scale the fleet in before it served a single chunk
            return ScaleDecision(mesh_width=mesh_width,
                                 batch_depth=batch_depth,
                                 reason="no timing yet")
        if occ[bottleneck] < self.idle_fraction:
            # everything idles: scale in one notch (narrower, shallower)
            widths = [d for d in range(1, mesh_width)
                      if n_streams % d == 0]
            return ScaleDecision(
                mesh_width=widths[-1] if widths else mesh_width,
                batch_depth=max(batch_depth - 1, self.min_depth),
                reason=f"idle (max occupancy {occ[bottleneck]:.2f})")
        if bottleneck == "camera" and occ["camera"] >= self.target_occupancy:
            wider = [d for d in range(mesh_width + 1, n_devices + 1)
                     if n_streams % d == 0]
            if not wider:
                # no wider width divides the current (padded) stream
                # count — e.g. 5 padded streams on width 1 with pow2
                # padding off. Admission re-pads for whatever width is
                # adopted (``admit`` keeps n_padded a multiple of it), so
                # divisibility of the *current* count must not veto the
                # scale-out — but only widths that actually shrink the
                # per-shard lane count qualify: widening past that just
                # claims devices for padding lanes (a single camera-bound
                # stream would otherwise escalate to n_devices, one fresh
                # compile per notch, with zero speedup).
                lanes_now = -(-n_streams // mesh_width)
                wider = [d for d in range(mesh_width + 1, n_devices + 1)
                         if -(-n_streams // d) < lanes_now]
            if wider:
                return ScaleDecision(
                    mesh_width=wider[0], batch_depth=batch_depth,
                    reason=f"camera-bound ({occ['camera']:.2f}): widen "
                           f"stream mesh {mesh_width}->{wider[0]}")
        if bottleneck == "server" and occ["server"] >= self.target_occupancy \
                and batch_depth < self.max_depth:
            return ScaleDecision(
                mesh_width=mesh_width, batch_depth=batch_depth + 1,
                reason=f"server-bound ({occ['server']:.2f}): deepen "
                       f"buffer {batch_depth}->{batch_depth + 1}")
        return ScaleDecision(mesh_width=mesh_width, batch_depth=batch_depth,
                             reason="steady")

    # -- admission control ----------------------------------------------------
    def admit(self, n_active: int, mesh_width: int = 1) -> AdmissionPlan:
        """Pad ``n_active`` streams to a compiled-shape-friendly width.

        The padded count is a multiple of ``mesh_width`` (stream-mesh
        divisibility), bucketed to powers of two when ``pad_pow2`` so the
        set of shapes ever compiled stays logarithmic under join/leave
        churn; any already-compiled shape that fits is reused outright.

        ``n_active == 0`` (every stream left) returns the empty plan —
        no lanes, no program, nothing compiled — so a closed-loop serve
        schedule can idle through all-quiet intervals without special
        casing; ``reused`` is True because the interval runs no fleet
        step at all."""
        if n_active < 0:
            raise ValueError("admit needs a non-negative stream count")
        if n_active == 0:
            return AdmissionPlan(n_active=0, n_padded=0,
                                 active=np.zeros(0, bool), reused=True)
        lanes = (n_active + mesh_width - 1) // mesh_width
        if self.pad_pow2:  # bucket the per-shard lane count, so the
            # result stays divisible by any mesh width
            lanes = 1 << (lanes - 1).bit_length()
        tight = lanes * mesh_width
        fits = [s for s in self._compiled_shapes
                if s >= n_active and s % mesh_width == 0]
        best = min(fits) if fits else None
        if tight in self._compiled_shapes:
            n_padded, reused = tight, True
        elif best is not None and best <= self.reuse_slack * tight:
            # bounded-waste reuse: a compiled shape close enough to the
            # tight bucket beats a fresh compile — but a fleet that
            # shrank far past it re-compiles the tight shape rather than
            # paying oversized camera steps every interval from now on
            n_padded, reused = best, True
        else:
            n_padded, reused = tight, False
            self._compiled_shapes.add(tight)
        reg = obs_metrics.get_metrics()
        if reg is not None:
            reg.counter("admissions_total").inc()
            reg.counter("admission_shape_reuse_total" if reused
                        else "admission_compiles_total").inc()
        if not reused:  # a fresh padded shape means a compile is coming:
            # worth a timeline mark even before the warm-up span lands
            tracer = obs_trace.get_tracer()
            if tracer is not None:
                tracer.instant("admit_new_shape", stage="admission",
                               n_active=n_active, n_padded=n_padded,
                               mesh_width=mesh_width)
        active = np.zeros(n_padded, bool)
        active[:n_active] = True
        return AdmissionPlan(n_active=n_active, n_padded=n_padded,
                             active=active, reused=reused)


def pad_streams(frames, n_padded: int):
    """Pad a (N, T, H, W, C) fleet batch up to ``n_padded`` streams by
    repeating the last stream (idle lanes carry real pixels so padded
    fleet steps exercise the identical program). ``frames`` is a numpy
    array or a tensor, padded where it lies (a tensor on the card is
    padded there, with no copy through the host)."""
    n = frames.shape[0]
    if n_padded < n:
        raise ValueError(f"cannot pad {n} streams down to {n_padded}")
    if n_padded == n:
        return frames
    if isinstance(frames, torch.Tensor):
        fill = frames[-1:].expand((n_padded - n,) + tuple(frames.shape[1:]))
        return torch.cat([frames, fill], dim=0)
    fill = np.repeat(frames[-1:], n_padded - n, axis=0)
    return np.concatenate([frames, fill], axis=0)
