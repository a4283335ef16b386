"""Pipelined multi-stream serving (port of ``repro.engine.multistream``):
one camera step per chunk interval serves N camera streams that share one
uplink, the server DNN is batched across the streams, and the stages
overlap. :meth:`MultiStreamEngine.serve_loop` closes the loop: streams
join and leave, admission re-pads the fleet shape, the rate controller
moves the knobs and the autoscaler the pipeline depth, all between chunks.

Per chunk interval the loop runs three stages: the fleet camera step
(``serve.steps.make_camera_fleet_step``, device), the batched server DNN
(``serve.steps.make_server_fleet_step``, device) and host-side accuracy
scoring plus processor-sharing uplink delays
(``core.pipeline.shared_stream_delays``, or ``UplinkClock.send_shared``
on a trace). With ``overlap=True`` the host scores chunk ci - depth while
the device still works on later chunks. Under ``detail="windowed"`` a
segmentation or keypoint fleet reduces accuracy on the device
(``serve.steps.make_accuracy_reduce_step``): only N scalars and the byte
matrix cross to the host, and a ``core.aggregate.FleetAggregator`` keeps
O(window) state in place of per-chunk lists.

What stands in for JAX's asynchronous dispatch: the steps enqueue their
kernels on the current CUDA stream and return. A plain ``.cpu()`` of the
server outputs would wait behind the camera step enqueued after them and
the overlap would vanish without an error, so the outputs and byte
matrices are copied to pinned host memory with ``non_blocking=True`` as
they are enqueued, a CUDA event is recorded after the copies, and
:meth:`MultiStreamEngine._finish` waits on that event only. The camera
step's end is an event too (the counterpart of
``jax.block_until_ready(decoded)``), not ``torch.cuda.synchronize()``.
Host frames are pinned once per run, and each chunk is copied to the card
stream by stream without waiting: a copy from pageable memory would wait
for the device queue to drain. The lane mask and the controller's knobs
go to the card the same way, so setting them never waits. On the CPU
every step runs synchronously.

Accounting follows the reference: per-stream ``encode_s`` is the fleet
camera step's time (under overlap, one hot step timed after warm-up);
server inference stays out of per-stream delay and is tracked in
``FleetResult.timing`` for serving-tier capacity only.

Tenants (``EngineConfig(tenants=, tenant_of=)``): with two or more, the
fleet steps become tenant-routed (``serve.steps.make_tenant_*``), each
interval's tenant-id lane goes to the card beside the lane mask (from
pinned memory, no wait), host scoring groups lanes by tenant, and
scale decisions carry each tenant's share of the lanes. The stream mesh
and multi-host suspend/resume come with the multi-GPU slice (ROADMAP
module 8).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.codec.codec import CHUNK_ENCODERS
from repro_torch.control.autoscaler import (USABLE_DEVICES, FleetAutoscaler,
                                            apply_churn, pad_streams)
from repro_torch.core.aggregate import AggregateConfig, AggregateResult
from repro_torch.core.pipeline import (ChunkResult, FleetTiming, NetworkConfig,
                                       RunResult, UplinkClock,
                                       shared_stream_delays)
from repro_torch.engine.config import EngineConfig
from repro_torch.engine.engine import synchronize
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.steps import (TenantLanes, make_accuracy_reduce_step,
                                     make_camera_fleet_step,
                                     make_server_fleet_step,
                                     make_tenant_accuracy_reduce_step,
                                     make_tenant_camera_fleet_step,
                                     make_tenant_server_fleet_step,
                                     to_device_async)
from repro_torch.vision.dnn import detection_keep_heat

_MODULE_8 = "the multi-GPU slice (ROADMAP module 8)"
#: the stream mesh's width: every usable card, one until module 8
_MESH_WIDTH = USABLE_DEVICES


class _EngineObs:
    """Per-run telemetry handles, resolved once so the per-interval cost
    is one attribute load + ``is not None`` branch when the plane is off.
    ``None`` fields mean that half of the plane is disabled.

    All recording uses values the engine already computed for its own
    accounting — no extra device synchronisation, no RNG — so telemetry
    can never perturb the data path. Metric recording in the host stage
    happens *after* ``timing.host_s.append``, so the measured host window
    stays clean."""

    __slots__ = ("tracer", "reg", "cam_c", "srv_c", "host_c",
                 "stage_h", "delay_h", "queue_h")

    def __init__(self):
        self.tracer = obs_trace.get_tracer()
        self.reg = reg = obs_metrics.get_metrics()
        if reg is not None:
            self.cam_c = reg.counter("stage_seconds_total", stage="camera")
            self.srv_c = reg.counter("stage_seconds_total", stage="server")
            self.host_c = reg.counter("stage_seconds_total", stage="host")
            self.stage_h = {
                s: reg.histogram("stage_seconds", stage=s)
                for s in ("camera", "server", "host")}
            self.delay_h = reg.histogram("chunk_delay_s")
            self.queue_h = reg.histogram("uplink_queue_s")

    def camera(self, ci: int, t0: float, wall: float, acct: float,
               n_lanes: int, n_active: int) -> None:
        tr = self.tracer
        if tr is not None:
            tr.complete("camera", "camera", t0, wall, ci=ci,
                        lanes=n_lanes, active=n_active)
        if self.reg is not None:
            self.cam_c.inc(acct if acct is not None else wall)
            self.stage_h["camera"].observe(wall)
            self.reg.gauge("lanes_active").set(n_active)
            self.reg.gauge("lanes_padded").set(n_lanes - n_active)

    def server(self, ci: int, t0: float, dur: float,
               estimated: bool) -> None:
        tr = self.tracer
        if tr is not None:
            args = {"ci": ci}
            if estimated:  # overlapped: steady-state estimate, the same
                args["estimated"] = True  # number FleetTiming reports
            tr.complete("server", "server", t0, dur, **args)
        if self.reg is not None:
            self.srv_c.inc(dur)
            self.stage_h["server"].observe(dur)

    def finish(self, ci: int, t0: float, host_dur: float, n_active: int,
               lane_bytes, delays, queue_s: float, cam_dt: float) -> None:
        """Host-scoring + uplink accounting for one finished interval.
        Called after ``timing.host_s.append`` so none of this work lands
        inside the measured host window."""
        tr = self.tracer
        tail = max(delays[:n_active], default=0.0) if n_active else 0.0
        if tr is not None:
            tr.complete("scoring", "scoring", t0, host_dur, ci=ci,
                        active=n_active)
            if n_active:
                # modelled transmit time (the accounting clock, not wall
                # clock): anchored at the scoring instant, duration =
                # the batch-tail upload + backlog wait
                tr.complete("uplink", "uplink", t0, queue_s + tail,
                            ci=ci, queue_s=queue_s,
                            bytes=float(sum(lane_bytes[:n_active])),
                            modelled=True)
        if self.reg is not None:
            self.host_c.inc(host_dur)
            self.stage_h["host"].observe(host_dur)
            self.reg.counter("chunks_served_total").inc(n_active)
            if n_active:
                self.reg.counter("wire_bytes_total").inc(
                    float(sum(lane_bytes[:n_active])))
                self.reg.gauge("uplink_backlog_s").set(queue_s)
                self.queue_h.observe(queue_s)
                self.delay_h.observe_many(
                    [d + cam_dt + queue_s for d in delays[:n_active]])

    def churn(self, ci: int, event) -> None:
        if self.tracer is not None:
            self.tracer.instant("churn", stage="events", ci=ci,
                                join=list(event.join),
                                leave=list(event.leave))
        if self.reg is not None:
            self.reg.counter("churn_joins_total").inc(len(event.join))
            self.reg.counter("churn_leaves_total").inc(len(event.leave))

    def slo_attainment(self, aggregate, tenants=None) -> None:
        """Windowed runs: export the aggregator's per-tier SLO attainment
        as gauges at run end, and on tenanted fleets the per-tenant
        attainment and volume (labelled by tenant name)."""
        if self.reg is not None and aggregate is not None:
            for tier, frac in aggregate.attainment().items():
                if frac == frac:  # skip empty tiers (NaN)
                    self.reg.gauge("slo_attainment", tier=tier).set(frac)
            if tenants is not None and aggregate.tenanted:
                for t, atts in enumerate(aggregate.attainment_by_tenant()):
                    name = tenants[t].name
                    self.reg.gauge("tenant_chunks_served",
                                   tenant=name).set(int(aggregate.t_n[t]))
                    for tier, frac in atts.items():
                        if frac == frac:
                            self.reg.gauge("tenant_slo_attainment",
                                           tenant=name,
                                           tier=tier).set(frac)

    def tenant_lanes(self, tenants, counts) -> None:
        """Per-interval active lanes of each tenant (the occupancy the
        capacity split divides by)."""
        if self.reg is not None:
            for t, spec in enumerate(tenants):
                self.reg.gauge("tenant_lanes_active",
                               tenant=spec.name).set(int(counts[t]))


@dataclasses.dataclass
class FleetResult:
    """Per-stream results plus fleet-level camera timing.

    Closed-loop runs (``serve_loop``) additionally carry the control
    plane's trajectory: ``stream_ids`` maps each entry of ``streams``
    back to its fleet lane id (churn means not every stream serves every
    chunk), ``decisions`` is the per-interval ``ScaleDecision`` record,
    and ``shapes`` the padded fleet shapes admission ever warmed up.
    Windowed runs return ``aggregate`` in place of ``streams``. Tenanted
    fleets carry ``tenant_ids``, the tenant of each entry of ``streams``
    (windowed runs keep the split in ``aggregate``). (The reference's
    multi-host ``hosts`` comes with module 8.)"""

    streams: List[RunResult]
    camera_s: List[float]     # fleet camera-step time per chunk
    timing: Optional[FleetTiming] = None  # full pipeline accounting
    stream_ids: Optional[List[int]] = None   # serve_loop: lane ids
    decisions: Optional[List] = None         # serve_loop: ScaleDecisions
    shapes: Optional[List[int]] = None       # serve_loop: padded shapes
    aggregate: Optional[AggregateResult] = None  # detail="windowed"
    served_cis: Optional[List[int]] = None  # chunk interval of each
    # ``camera_s`` entry (all-quiet intervals append neither)
    tenant_ids: Optional[List[int]] = None  # tenanted: tenant of each
    # entry of ``streams``

    @property
    def n_streams(self):
        if not self.streams and self.aggregate is not None:
            return self.aggregate.n_streams
        return len(self.streams)

    @property
    def accuracy(self):
        if not self.streams and self.aggregate is not None:
            return self.aggregate.accuracy
        return float(np.mean([r.accuracy for r in self.streams]))

    @property
    def mean_camera_s(self):
        return float(np.mean(self.camera_s))

    @property
    def chunks_per_s(self):
        """Fleet camera throughput: stream-chunks processed per second."""
        return self.n_streams / max(self.mean_camera_s, 1e-12)

    def accuracy_by_tenant(self):
        """Per-tenant mean accuracy, a tuple indexed by tenant id.
        Windowed runs read the aggregate's per-tenant sums; per-chunk
        runs group ``streams`` by ``tenant_ids`` and mean the per-stream
        accuracies (as a dedicated fleet's ``accuracy`` does)."""
        if not self.streams and self.aggregate is not None \
                and self.aggregate.tenanted:
            return self.aggregate.accuracy_by_tenant()
        if self.tenant_ids is None:
            raise ValueError("untenanted result has no per-tenant "
                             "accuracy; serve with EngineConfig(tenants"
                             "=...)")
        by_t: dict = {}
        for t, r in zip(self.tenant_ids, self.streams):
            by_t.setdefault(int(t), []).append(r.accuracy)
        n = max(by_t) + 1 if by_t else 0
        return tuple(float(np.mean(by_t[t])) if t in by_t
                     else float("nan") for t in range(n))

    def _delay_percentile(self, q: float) -> float:
        if not self.streams and self.aggregate is not None:
            return self.aggregate.delay_percentile(q)
        delays = [c.total_delay_s for r in self.streams for c in r.chunks]
        # a serve_loop schedule where no stream ever served is legal
        return float(np.percentile(delays, q)) if delays else float("nan")

    @property
    def p90_delay(self):
        """Tail end-to-end chunk delay pooled over every stream-chunk."""
        return self._delay_percentile(90)

    def summary(self):
        s = {
            "n_streams": self.n_streams,
            "accuracy": self.accuracy,
            "camera_s_per_chunk": self.mean_camera_s,
            "chunks_per_s": self.chunks_per_s,
            "p95_delay_s": self._delay_percentile(95),
        }
        if self.timing is not None:
            s.update(wall_s=self.timing.wall_s,
                     serialized_s=self.timing.serialized_s,
                     overlap_speedup=self.timing.overlap_speedup)
        if self.shapes is not None:
            s.update(n_compiled_shapes=len(self.shapes),
                     p90_delay_s=self.p90_delay)
        if self.decisions is not None:
            s["n_rescales"] = sum(
                1 for a, b in zip(self.decisions, self.decisions[1:])
                if (a.mesh_width, a.batch_depth)
                != (b.mesh_width, b.batch_depth))
        if self.aggregate is not None:
            s.update(self.aggregate.summary())
        return s


def _record(device: torch.device):
    """A CUDA event recorded on the current stream (None on the CPU, where
    every step has already finished)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record()
    return event


def _wait(event):
    if event is not None:
        event.synchronize()


def _to_host(tree: dict) -> dict:
    """Start copying a dict of tensors to the host. From the card the copy
    goes to pinned memory without waiting (``non_blocking``); read the
    results only after an event recorded behind it has completed."""
    return {k: v.to("cpu", non_blocking=True) for k, v in tree.items()}


def _lane_flags(active: np.ndarray, device: torch.device) -> torch.Tensor:
    """The admission plan's (n_padded,) lane mask as a tensor on
    ``device``, copied from pinned memory without waiting, as
    ``ControlKnobs.as_array`` copies the knobs."""
    return to_device_async(np.asarray(active, bool), device)


def _chunk_source(frames, device: torch.device):
    """``put(s, e, ids=None)``: the frames ``[ids, s:e]`` of streams
    ``ids`` (default: all) on ``device``, in ``ids`` order."""
    if isinstance(frames, torch.Tensor) and frames.device == device:
        def put_resident(s, e, ids=None):
            if ids is None:
                return frames[:, s:e]
            return torch.stack([frames[i, s:e] for i in ids])

        return put_resident
    if isinstance(frames, torch.Tensor):
        frames = frames.cpu().numpy()
    host = np.asarray(frames, np.float32)
    if device.type != "cuda":
        def put_host(s, e, ids=None):
            sel = host[:, s:e] if ids is None else host[list(ids), s:e]
            return torch.from_numpy(np.ascontiguousarray(sel))

        return put_host
    # pinned once per run; each stream's slice of it is contiguous
    pinned = torch.from_numpy(np.ascontiguousarray(host)).pin_memory()
    pinned_np = pinned.numpy()

    def put(s, e, ids=None):
        ids = range(host.shape[0]) if ids is None else ids
        out = torch.empty((len(ids), e - s) + host.shape[2:],
                          dtype=torch.float32, device=device)
        for j, i in enumerate(ids):
            out[j].copy_(torch.from_numpy(pinned_np[i, s:e]),
                         non_blocking=True)
        return out

    put.keep_alive = pinned  # the copies read it until they complete
    return put


class MultiStreamEngine:
    """Batched AccMPEG serving for N cameras sharing one uplink, on one
    device (``device``, default ``"cuda"``; ``"cpu"`` runs the plain
    PyTorch paths).

    ``config`` (:class:`~repro_torch.engine.config.EngineConfig`):
    ``impl`` names the chunk-encoder backend ("fused" / "fused_exact" take
    the stream-batched scores kernel); ``overlap`` pipelines the server
    DNN and host scoring against later chunks' camera steps (False = the
    serialized camera -> server -> host loop); ``depth`` chunks stay in
    flight when overlapped; ``trace`` prices per-chunk uploads on a
    time-varying shared uplink (``UplinkClock.send_shared``), uploads
    queueing behind the previous chunk's; ``controller`` (a
    ``RateController``) makes the camera step knob-taking, its knob
    tensor riding along each dispatch and each finished chunk's tail
    delay feeding back (lagging by the pipeline depth under overlap);
    ``autoscaler`` (a ``FleetAutoscaler``) turns each ``run``'s timing
    into a ``ScaleDecision`` (``last_scale``) that :meth:`apply_scale`
    adopts, and decides between chunks inside :meth:`serve_loop`;
    ``detail`` "chunks" scores all lanes in one vectorized pass, "legacy"
    lane by lane (bit-identical), "windowed" folds them into an
    ``aggregate`` summary; ``sim_encode_s`` replaces the accounted camera
    time with a constant (the measured ``FleetTiming`` stays).

    A config with ``tenants`` takes ``MultiStreamEngine(None, None,
    config=...)``: each tenant brings its DNN and AccModel (on
    ``device``). One tenant serves the single-DNN path; two or more the
    tenant-routed one, which refuses a ``controller`` (its knobs are
    fleet-wide, the tenants' quality configs are not).
    """

    def __init__(self, final_dnn=None, accmodel=None, *,
                 config: Optional[EngineConfig] = None, device="cuda"):
        config = config or EngineConfig()
        self.config = config
        # one tenant folds into the single-DNN engine (its DNN, AccModel
        # and QualityConfig); two or more take the tenant-routed steps
        self.tenants = config.tenants
        self._tenanted = config.tenanted
        self._tenant_of = dict(config.tenant_of or {})
        if self.tenants is not None:
            if final_dnn is not None or accmodel is not None:
                raise ValueError(
                    "EngineConfig(tenants=...) declares the served "
                    "DNN/AccModel per tenant; do not also pass "
                    "final_dnn/accmodel")
            if self._tenanted and config.controller is not None:
                raise ValueError(
                    "multi-tenant fleets do not support the rate "
                    "controller yet: its knob array is fleet-wide while "
                    "tenants carry per-tenant quality configs")
            final_dnn = self.tenants[0].dnn
            accmodel = self.tenants[0].accmodel
        self.final_dnn = final_dnn
        self.accmodel = accmodel
        self.device = resolve_device(device)
        # a tenanted engine keeps per-lane configs in its camera step and
        # never reads self.qcfg on the data path
        self.qcfg = self.tenants[0].qcfg if self.tenants is not None \
            and not self._tenanted else config.qcfg
        # mutable runtime attributes seeded from the frozen config:
        # apply_scale and serve_loop move overlap / depth at run time
        self.net = config.net
        self.chunk_size = config.chunk_size
        self.impl = config.impl
        self.overlap = config.overlap
        self.depth = config.depth
        self.trace = config.trace
        self.controller = config.controller
        self.autoscaler = config.autoscaler
        self.fps = config.fps
        self.sim_encode_s = config.sim_encode_s
        self.detail = config.detail
        self.aggregate = config.aggregate  # for detail="windowed"
        self.device_reduce = config.device_reduce
        self.last_scale = None  # the autoscaler's latest ScaleDecision
        CHUNK_ENCODERS.resolve(config.impl)  # fail on a bad name now
        self._steps = {}  # (controlled, masked) -> (camera, server)
        self._acc_step = None  # the device accuracy reduce, once built
        self._warm = {}   # (shape, refs is None, ...) -> steady times
        self._refs_prepared = None  # (refs object, prepared copy)
        self._agg = None  # live FleetAggregator during a windowed run
        self._obs = None  # per-run telemetry handles (None = plane off)

    @property
    def last_serve_state(self):
        raise NotImplementedError(
            f"serve_loop's exported resume state comes with {_MODULE_8}")

    # -- tenancy helpers ------------------------------------------------------
    def _tenant_idx(self, sid: int) -> int:
        return self._tenant_of.get(sid, 0)

    def _dnn_for_sid(self, sid: int):
        """The server DNN that scores stream ``sid``."""
        if self._tenanted:
            return self.tenants[self._tenant_idx(sid)].dnn
        return self.final_dnn

    def _tenant_lane_ids(self, sids, n_lanes: int) -> TenantLanes:
        """The (n_lanes,) tenant-id lane of a batch whose active prefix
        serves ``sids``; padded lanes route to tenant 0 (their bytes are
        zeroed and they are never scored, like every padding lane)."""
        lane = np.zeros(n_lanes, np.int64)
        for i, sid in enumerate(sids):
            lane[i] = self._tenant_idx(sid)
        return TenantLanes(lane, len(self.tenants), self.device)

    def _tenant_counts(self, sids) -> List[int]:
        """Active streams per tenant: the occupancy the autoscaler's
        capacity split divides by."""
        counts = [0] * len(self.tenants)
        for sid in sids:
            counts[self._tenant_idx(sid)] += 1
        return counts

    # -- step construction ---------------------------------------------------
    def _steps_for(self, masked: bool = False):
        """The camera and server steps. The camera step's arity depends on
        the controller's presence and on the lane mask, so both key the
        cache; a knob, membership or tenant-mix change reuses the
        entry."""
        key = (self.controller is not None, masked)
        if key not in self._steps:
            if self._tenanted:
                self._steps[key] = (
                    make_tenant_camera_fleet_step(self.tenants,
                                                  impl=self.impl,
                                                  mask=masked),
                    make_tenant_server_fleet_step(self.tenants))
            else:
                self._steps[key] = (
                    make_camera_fleet_step(self.accmodel, self.qcfg,
                                           impl=self.impl,
                                           knobs=self.controller is not None,
                                           mask=masked),
                    make_server_fleet_step(self.final_dnn))
        return self._steps[key]

    def _build_agg(self):
        """The windowed run's aggregator; a tenanted fleet threads its
        stream -> tenant map and the tenants' SLO ladders through, so the
        result carries per-tenant attainment."""
        cfg = self.aggregate or AggregateConfig()
        if not self._tenanted:
            return cfg.build()
        return cfg.build(tenant_of=dict(self._tenant_of),
                         tenant_tiers=tuple(t.tiers for t in self.tenants))

    def _use_device_reduce(self, refs) -> bool:
        """Device accuracy reduction applies only when the run is windowed
        (no per-chunk results wanted), references are computed in-loop
        (precomputed refs live on the host), and the task has a
        device-reducible metric (not detection; on a tenanted fleet, every
        tenant's task)."""
        dnns = [t.dnn for t in self.tenants] if self._tenanted \
            else [self.final_dnn]
        return (self.detail == "windowed" and self.device_reduce
                and refs is None
                and all(d.supports_device_accuracy for d in dnns))

    def _acc_step_for(self):
        if self._acc_step is None:
            self._acc_step = make_tenant_accuracy_reduce_step(self.tenants) \
                if self._tenanted else \
                make_accuracy_reduce_step(self.final_dnn)
        return self._acc_step

    # -- steady-state timing --------------------------------------------------
    def _steady_times(self, camera, server_step, warm, refs_none: bool,
                      overlap: bool, key, acc_step=None):
        """Run the camera and server steps (and the accuracy reduce) once
        outside the timed loop (the first launch also builds the kernels,
        and the first call at a shape pays cuDNN's setup), then, under
        overlap, time one hot step of each: the steady-state estimates
        that per-stream ``encode_s`` and ``timing.server_s`` report while
        the pipelined loop's spans absorb overlapped work. Stored in
        ``_warm`` under ``key``: callers look there first, so a repeat
        visit to a fleet shape makes no warm-up."""
        t_warm = time.perf_counter()
        d0 = camera(warm)[0]
        so = server_step(d0)
        if acc_step is not None:
            acc_step(so, so)
        synchronize(self.device)
        tracer = obs_trace.get_tracer()
        if tracer is not None:  # a warm-up stalls the host mid-run: make
            # it visible on the timeline
            tracer.complete("warm_compile", "warmup", t_warm,
                            time.perf_counter() - t_warm,
                            shape=list(warm.shape))
        reg = obs_metrics.get_metrics()
        if reg is not None:
            reg.counter("warm_compiles_total").inc()
            reg.histogram("warmup_seconds").observe(
                time.perf_counter() - t_warm)
        cam_steady_s = server_steady_s = 0.0
        if overlap:  # serialized mode measures stages per chunk instead
            t0 = time.perf_counter()
            camera(warm)
            synchronize(self.device)
            cam_steady_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            server_step(d0)
            if refs_none:  # refs=None: second server pass per chunk
                server_step(warm)
            synchronize(self.device)
            server_steady_s = time.perf_counter() - t0
        self._warm[key] = (cam_steady_s, server_steady_s)
        return self._warm[key]

    def apply_scale(self, decision=None) -> "MultiStreamEngine":
        """Adopt a ``ScaleDecision`` (default: the last one) for the next
        run: buffer depth and overlap on/off. A stream mesh wider than
        one card comes with module 8."""
        d = decision or self.last_scale
        if d is None:
            raise ValueError("no ScaleDecision to apply (run first, or "
                             "pass one)")
        if d.mesh_width > 1:
            raise NotImplementedError(
                f"apply_scale: a stream mesh of {d.mesh_width} cards comes "
                f"with {_MODULE_8}")
        self.overlap = d.overlap
        self.depth = d.batch_depth
        return self

    def _prepare_refs(self, refs):
        """References as host numpy trees, prepared once up front: raw
        high-quality frames become server-DNN outputs, and detection refs
        get their NMS (``"keep"``), so the per-chunk host stage touches
        numpy only. Cached by the identity of ``refs``, which are treated
        as immutable once passed."""
        if refs is None:
            return None
        if self._refs_prepared is not None and self._refs_prepared[0] is refs:
            return self._refs_prepared[1]
        prepared = []
        for sid, stream_refs in enumerate(refs):
            # each stream's references through its own tenant's DNN
            dnn = self._dnn_for_sid(sid)
            detection = dnn.task == "detection"
            row = []
            for r in stream_refs:
                if not isinstance(r, dict):  # raw frames -> D(ref)
                    r = dnn.predict(r)
                r = {k: torch.as_tensor(v) for k, v in r.items()}
                if detection and "keep" not in r:
                    r["keep"] = detection_keep_heat(r)
                row.append({k: v.detach().cpu().numpy()
                            for k, v in r.items()})
            prepared.append(row)
        self._refs_prepared = (refs, prepared)
        return prepared

    # -- chunk post-processing (host side) ------------------------------------
    def _finish(self, p, per_stream, net, refs, timing, overlap: bool,
                clock=None):
        """Host scoring and uplink accounting for one chunk. It waits only
        for this chunk's copies to the host; under overlap the device
        meanwhile runs the later chunks' steps.

        ``p["ids"]`` (``serve_loop`` chunks) maps active lanes to fleet
        stream ids; lanes past ``len(ids)`` are admission padding whose
        wire bytes the masked camera step already zeroed. They ride
        through the uplink solvers at zero cost and are never scored, so
        padding adds exactly nothing to accuracy, bytes or delay. Each
        chunk carries its own byte matrix, so a chunk still in flight
        when admission changes the padded shape finishes with its own
        lane count.

        Scoring dispatches on ``self.detail``; under "windowed" the lane
        batch folds into the run's ``FleetAggregator`` and nothing is
        appended. A chunk that carries device-reduced accuracies
        (``p["acc_dev"]``) never fetched its dense outputs at all."""
        _wait(p["ready"])
        acc_dev = p.get("acc_dev")
        if acc_dev is None:
            outs = {k: v.numpy() for k, v in p["outs"].items()}
            ref_outs = None if p["ref_outs"] is None else {
                k: v.numpy() for k, v in p["ref_outs"].items()}
        else:
            acc_dev = acc_dev.numpy()
        if overlap:
            timing.server_s.append(p["server_steady_s"])
        t0 = time.perf_counter()
        ci = p["ci"]
        ids = p.get("ids")  # serve_loop: active lane i -> stream ids[i]
        pbytes = p["pbytes"].numpy()
        n_lanes = pbytes.shape[0]
        n_active = n_lanes if ids is None else len(ids)
        # .tolist() feeds the delay solvers and the controller the same
        # Python floats as the reference
        lane_bytes = pbytes.reshape(n_lanes, -1).sum(axis=1).tolist()
        if clock is None:
            # price the uplink over active lanes only: padded lanes are
            # not cameras, and counting them would grant the fleet
            # phantom capacity (active lanes lead, so this is a prefix)
            delays = shared_stream_delays(lane_bytes[:n_active], net)
            delays += [0.0] * (n_lanes - len(delays))
            queue_s = 0.0
        else:
            # the trace's capacity is absolute, so zero-byte padded lanes
            # already ride along at zero cost
            delays, queue_s = clock.send_shared(ci, lane_bytes, p["cam_dt"])
        if n_active and self.detail == "legacy":
            for i in range(n_active):
                sid = i if ids is None else ids[i]
                out_i = {k: v[i] for k, v in outs.items()}
                ref = refs[sid][ci] if refs is not None else {
                    k: v[i] for k, v in ref_outs.items()}
                per_stream[sid].append(ChunkResult(
                    self._dnn_for_sid(sid).accuracy(out_i, ref),
                    lane_bytes[i],
                    encode_s=p["cam_dt"], overhead_s=0.0,
                    stream_s=delays[i], queue_s=queue_s, ci=ci))
        elif n_active:
            sids = list(range(n_active)) if ids is None else list(ids)
            if acc_dev is not None:
                accs = np.asarray(acc_dev, np.float64)[:n_active]
            else:
                # host scoring grouped by tenant (one group without
                # tenants): each DNN scores its own lanes in one batched
                # call, reading only its task's keys of the outputs
                accs = np.zeros(n_active, np.float64)
                lane_t = np.asarray([self._tenant_idx(sid) for sid in sids])
                for t in np.unique(lane_t):
                    rows = np.flatnonzero(lane_t == t)
                    o_t = {k: v[rows] for k, v in outs.items()}
                    if refs is not None:
                        ref_t = {k: np.stack([refs[sids[i]][ci][k]
                                              for i in rows])
                                 for k in refs[sids[rows[0]]][ci]}
                    else:
                        ref_t = {k: v[rows] for k, v in ref_outs.items()}
                    accs[rows] = self._dnn_for_sid(
                        sids[rows[0]]).accuracy_batched(o_t, ref_t)
            if self.detail == "windowed":
                total = (np.asarray(delays[:n_active], np.float64)
                         + p["cam_dt"] + queue_s)
                self._agg.observe(ci, sids, accs,
                                  np.asarray(lane_bytes[:n_active],
                                             np.float64), total)
            else:
                for i in range(n_active):
                    per_stream[sids[i]].append(ChunkResult(
                        float(accs[i]), lane_bytes[i],
                        encode_s=p["cam_dt"], overhead_s=0.0,
                        stream_s=delays[i], queue_s=queue_s, ci=ci))
        if self.controller is not None and n_active:
            from repro_torch.control.controller import ChunkObservation

            # the fleet shares one uplink, so the controller tracks the
            # batch tail over active lanes; used_knobs is what this chunk
            # was dispatched with (under overlap the level has moved
            # since). An all-quiet drain has no tail and gives nothing.
            self.controller.observe(ChunkObservation(
                n_bytes=float(sum(lane_bytes[:n_active])),
                stream_s=max(delays[:n_active]),
                queue_s=queue_s, compute_s=p["cam_dt"],
                n_streams=n_active),
                used_knobs=p.get("knobs"))
        host_dur = time.perf_counter() - t0
        timing.host_s.append(host_dur)
        ob = self._obs
        if ob is not None:  # after host_s.append: outside the host window
            if overlap:
                ob.server(ci, t0, p["server_steady_s"], True)
            ob.finish(ci, t0, host_dur, n_active, lane_bytes, delays,
                      queue_s, p["cam_dt"])

    def _serve_interval(self, ci, batch, camera, server_step, acc_step,
                        refs_none: bool, steady, pending, finish, timing,
                        n_lanes: int, ids=None) -> float:
        """One chunk interval of either loop: dispatch the camera step,
        score the chunk ``depth`` behind it (under overlap) while the card
        works, charge the camera time, enqueue the server step (and the
        reference pass without refs, and the device accuracy reduce),
        start the copies of what the host stage reads and record their
        event; serialized, wait and score at once. ``finish(p, overlap)``
        is the loop's host stage. Returns the camera time."""
        cam_steady_s, server_steady_s = steady
        knobs_used = self.controller.knobs() \
            if self.controller is not None else None
        t0 = time.perf_counter()
        decoded, pbytes, _ = camera(batch)    # enqueued
        cam_ready = _record(self.device)
        if self.overlap and len(pending) >= self.depth:
            finish(pending.pop(0), True)
        _wait(cam_ready)
        cam_dt = cam_steady_s if self.overlap else time.perf_counter() - t0
        timing.camera_s.append(cam_dt)
        # accounting charge: the measured step time, or the fixed
        # simulation constant
        acct_dt = cam_dt if self.sim_encode_s is None else self.sim_encode_s
        if self._obs is not None:
            wall = cam_dt if not self.overlap else time.perf_counter() - t0
            self._obs.camera(ci, t0, wall, cam_dt, n_lanes,
                             n_lanes if ids is None else len(ids))
        t1 = time.perf_counter()
        entry = dict(ci=ci, cam_dt=acct_dt, server_steady_s=server_steady_s,
                     knobs=knobs_used)
        if ids is not None:
            entry["ids"] = ids
        outs = server_step(decoded)           # batched server DNN
        ref_outs = server_step(batch) if refs_none else None
        if acc_step is not None:
            # reduce accuracy on the device and let the dense outputs die
            # there: only (N,) scalars and the byte matrix reach the host
            entry.update(outs=None, ref_outs=None, acc_dev=acc_step(
                outs, ref_outs).to("cpu", non_blocking=True))
        else:
            entry.update(outs=_to_host(outs), ref_outs=None
                         if ref_outs is None else _to_host(ref_outs))
        entry["pbytes"] = pbytes.to("cpu", non_blocking=True)
        entry["ready"] = _record(self.device)
        pending.append(entry)
        if not self.overlap:
            _wait(entry["ready"])
            srv_dt = time.perf_counter() - t1
            timing.server_s.append(srv_dt)
            if self._obs is not None:
                self._obs.server(ci, t1, srv_dt, False)
            finish(pending.pop(0), False)
        return cam_dt

    def _begin_run(self, refs):
        """Per-run state shared by ``run`` and ``serve_loop``."""
        refs = self._prepare_refs(refs)
        if self.detail == "windowed":
            self._agg = self._build_agg()
        if self.controller is not None:
            self.controller.reset()
        clock = None if self.trace is None else \
            UplinkClock(self.trace, self.chunk_size, self.fps)
        self._obs = _EngineObs() \
            if (obs_trace.enabled() or obs_metrics.enabled()) else None
        return refs, clock

    # -- the pipelined fleet loop ---------------------------------------------
    def run(self, frames, refs: Optional[Sequence[Sequence]] = None,
            net: Optional[NetworkConfig] = None) -> FleetResult:
        """frames (N, T, H, W, C), numpy or a tensor; refs[i][ci]:
        per-stream per-chunk D(H) references (optional; without them the
        reference outputs are the server DNN on the raw chunk, batched like
        everything else)."""
        N, T = frames.shape[:2]
        cs = self.chunk_size
        net = net or self.net or NetworkConfig.shared(2.5e6, N)
        cam_step, server_step = self._steps_for()
        per_stream: List[List[ChunkResult]] = [[] for _ in range(N)]
        timing = FleetTiming()
        starts = list(range(0, T - T % cs, cs))
        refs, clock = self._begin_run(refs)
        use_dev = self._use_device_reduce(refs)
        acc_step = self._acc_step_for() if use_dev else None
        controlled = self.controller is not None
        put = _chunk_source(frames, self.device)
        dev = self.device
        tids = None
        if self._tenanted:
            # stream i is lane i in run(); every step takes the lane
            tids = self._tenant_lane_ids(range(N), N)
            server_step = (lambda d, _s=server_step: _s(d, tids))
            if acc_step is not None:
                acc_step = (lambda o, r, _a=acc_step: _a(o, r, tids))

        def camera(batch):
            if tids is not None:  # the tenant-routed step
                return cam_step(batch, tids)
            if controlled:  # the knob tensor rides along: same step
                return cam_step(batch, self.controller.knob_array(dev))
            return cam_step(batch)

        warm_key = (tuple(frames.shape), refs is None, self.overlap,
                    controlled, use_dev)
        steady = self._warm.get(warm_key) or self._steady_times(
            camera, server_step, put(0, cs), refs is None, self.overlap,
            warm_key, acc_step=acc_step)

        # ``depth`` chunks stay in flight: at iteration ci the host scores
        # chunk ci - depth, whose outputs are long since on the host, while
        # the device queue holds the later chunks' server and camera steps
        pending: List[dict] = []

        def finish(p, overlap):
            self._finish(p, per_stream, net, refs, timing, overlap, clock)

        t_run = time.perf_counter()
        for ci, s in enumerate(starts):
            self._serve_interval(ci, put(s, s + cs), camera, server_step,
                                 acc_step, refs is None, steady, pending,
                                 finish, timing, N)
        while pending:
            finish(pending.pop(0), self.overlap)
        timing.wall_s = time.perf_counter() - t_run
        if self.autoscaler is not None:
            # tenant_streams only when tenanted: an autoscaler without the
            # argument still serves the single-DNN engine
            tkw = ({"tenant_streams": self._tenant_counts(range(N))}
                   if self._tenanted else {})
            self.last_scale = self.autoscaler.decide(
                timing, N, mesh_width=_MESH_WIDTH,
                batch_depth=self.depth if self.overlap else 1, **tkw)
        served_cis = list(range(len(starts)))  # run(): ci == position
        if self.detail == "windowed":
            agg, self._agg = self._agg.result(), None
            if self._obs is not None:
                self._obs.slo_attainment(
                    agg, self.tenants if self._tenanted else None)
            return FleetResult([], timing.camera_s, timing=timing,
                               aggregate=agg, served_cis=served_cis)
        streams = [RunResult(f"accmpeg_fleet[{i}]", per_stream[i])
                   for i in range(N)]
        return FleetResult(streams, timing.camera_s, timing=timing,
                           served_cis=served_cis,
                           tenant_ids=[self._tenant_idx(i) for i in range(N)]
                           if self._tenanted else None)

    # -- the closed-loop churn serving loop -----------------------------------
    def serve_loop(self, frames, events=(), refs=None, initial=None,
                   net: Optional[NetworkConfig] = None, rescale: bool = True,
                   decide_every: int = 1, owned=None, start_chunk: int = 0,
                   stop_chunk: Optional[int] = None,
                   state: Optional[dict] = None) -> FleetResult:
        """Closed-loop fleet serving under stream churn: scaling happens
        inside the loop, not between runs.

        ``frames`` (numpy or a tensor) is the (N_total, T, H, W, C) union
        of every camera that ever serves; its leading index is the stream
        id. ``initial`` names the ids active at chunk 0 (default: all),
        and ``events`` (``control.autoscaler.ChurnEvent``) join/leave
        streams at chunk boundaries. Per interval the loop:

        1. folds the interval's churn events into the active set,
        2. re-admits it through ``FleetAutoscaler.admit``: active streams
           pad up to a power of two, so the set of fleet shapes ever
           warmed up stays logarithmic in N_max while the lane mask (a
           device tensor, never a constant) carries membership,
        3. dispatches the masked camera fleet step on the padded batch
           (padded lanes repeat the last real stream so every lane runs
           the same code, but their wire bytes are zeroed on the device),
        4. scores and prices only active lanes: padding adds exactly zero
           to accuracy, bytes and delay, and the shared ``UplinkClock``,
           which survives churn, backlog and all, sees zero-byte uploads
           for idle lanes,
        5. hands the interval's ``FleetTiming`` window to
           ``FleetAutoscaler.decide`` and adopts the ``ScaleDecision``
           between chunks via :meth:`apply_scale`: no engine teardown, no
           new warm-up for shapes already admitted.

        ``admit(0)`` (everyone left) idles the interval: in-flight chunks
        drain, the uplink clock keeps its backlog, and a later join
        resumes with it. ``rescale=False`` pins the entered depth
        (admission still adapts the padded shape). ``decide_every``
        spaces out scale decisions. Warm-ups of shapes first admitted
        mid-loop are kept out of ``timing.wall_s``.

        ``owned``, ``start_chunk``, ``stop_chunk`` and ``state`` (the
        reference's stream ownership and suspend/resume for elastic
        hosts) come with module 8 and raise when set.

        Returns a :class:`FleetResult` whose ``streams`` hold one
        ``RunResult`` per stream id that ever served (``stream_ids`` maps
        them back), plus the ``decisions`` and ``shapes`` trajectories."""
        unported = {"owned": owned is not None,
                    "start_chunk": start_chunk != 0,
                    "stop_chunk": stop_chunk is not None,
                    "state": state is not None}
        for name, given in unported.items():
            if given:
                raise NotImplementedError(
                    f"serve_loop({name}=...): stream ownership and "
                    f"suspend/resume come with {_MODULE_8}")
        N_total, T = frames.shape[:2]
        cs = self.chunk_size
        starts = list(range(0, T - T % cs, cs))
        n_int = len(starts)
        events = tuple(events)
        for ev in events:
            if ev.chunk >= n_int:
                raise ValueError(f"churn event at chunk {ev.chunk} never "
                                 f"fires; schedule has {n_int} "
                                 f"intervals")
            for sid in ev.join + ev.leave:
                if not 0 <= sid < N_total:
                    raise ValueError(f"churn event names stream {sid}; "
                                     f"fleet has {N_total}")
        if self.autoscaler is None:
            self.autoscaler = FleetAutoscaler()
        scaler = self.autoscaler
        active_ids = list(range(N_total)) if initial is None \
            else list(initial)
        if len(set(active_ids)) != len(active_ids):
            raise ValueError(f"duplicate stream ids in initial: "
                             f"{active_ids}")
        for sid in active_ids:
            if not 0 <= sid < N_total:
                raise ValueError(f"initial names stream {sid}; fleet "
                                 f"has {N_total}")
        net = net or self.net or NetworkConfig.shared(2.5e6,
                                                      max(N_total, 1))
        controlled = self.controller is not None
        refs, clock = self._begin_run(refs)
        use_dev = self._use_device_reduce(refs)
        acc_step = self._acc_step_for() if use_dev else None
        put = _chunk_source(frames, self.device)
        dev = self.device
        per_stream: dict = {sid: [] for sid in range(N_total)}
        timing = FleetTiming()
        served_cis: List[int] = []
        decisions: List = []
        pending: List[dict] = []

        def finish(p, overlap):
            self._finish(p, per_stream, net, refs, timing, overlap, clock)

        frame_shape = tuple(frames.shape[2:])
        warm_s = 0.0  # warm-ups of shapes admitted mid-loop; kept out of
        # wall_s so it stays comparable to run()'s
        t_run = time.perf_counter()
        for ci in range(n_int):
            s = starts[ci]
            active_ids = apply_churn(active_ids, events, ci)
            if self._obs is not None:
                for ev in events:
                    if ev.chunk == ci and (ev.join or ev.leave):
                        self._obs.churn(ci, ev)
            plan = scaler.admit(len(active_ids), mesh_width=_MESH_WIDTH)
            if plan.n_padded == 0:
                # all-quiet interval: drain in-flight work; the uplink
                # clock keeps its backlog, ready for the next join
                while pending:
                    finish(pending.pop(0), self.overlap)
                continue
            depth = self.depth if self.overlap else 1
            cam_step, server_step = self._steps_for(masked=True)
            mask_dev = _lane_flags(plan.active, dev)
            ids = list(active_ids)
            tids = t_counts = None
            srv, acc = server_step, acc_step
            if self._tenanted:
                # the tenant-id lane rides beside the lane mask: padded
                # lanes route to tenant 0 and are masked as ever, so a new
                # tenant mix at an admitted shape builds nothing
                tids = self._tenant_lane_ids(ids, plan.n_padded)
                srv = (lambda d, _s=server_step, _t=tids: _s(d, _t))
                if acc_step is not None:
                    acc = (lambda o, r, _a=acc_step, _t=tids: _a(o, r, _t))
                t_counts = self._tenant_counts(ids)
                if self._obs is not None:
                    self._obs.tenant_lanes(self.tenants, t_counts)

            def camera(batch, _mask=mask_dev, _tids=tids):
                if _tids is not None:  # the tenant-routed masked step
                    return cam_step(batch, _tids, _mask)
                if controlled:  # fresh knob values, the same step
                    return cam_step(batch, _mask,
                                    self.controller.knob_array(dev))
                return cam_step(batch, _mask)

            warm_key = ((plan.n_padded, cs) + frame_shape, refs is None,
                        self.overlap, controlled, use_dev, "masked")
            steady = self._warm.get(warm_key)
            if steady is None:  # a new padded shape: warm it up
                t_warm = time.perf_counter()
                steady = self._steady_times(
                    camera, srv,
                    pad_streams(put(s, s + cs, ids), plan.n_padded),
                    refs is None, self.overlap, warm_key, acc_step=acc)
                warm_s += time.perf_counter() - t_warm

            host_before = len(timing.host_s)
            t_int = time.perf_counter()
            cam_dt = self._serve_interval(
                ci, pad_streams(put(s, s + cs, ids), plan.n_padded), camera,
                srv, acc, refs is None, steady, pending, finish, timing,
                plan.n_padded, ids)
            served_cis.append(ci)
            if rescale and (ci + 1) % max(decide_every, 1) == 0:
                # decide on the freshest interval window only: stale
                # occupancies from another fleet shape would fight the
                # one-notch damping
                srv_est = steady[1] if self.overlap else timing.server_s[-1]
                window = FleetTiming(
                    camera_s=[cam_dt], server_s=[srv_est],
                    host_s=list(timing.host_s[host_before:]),
                    wall_s=time.perf_counter() - t_int)
                tkw = ({"tenant_streams": t_counts}
                       if t_counts is not None else {})
                d = scaler.decide(window, plan.n_padded,
                                  mesh_width=_MESH_WIDTH, batch_depth=depth,
                                  **tkw)
                decisions.append(d)
                self.last_scale = d
                if (d.mesh_width, d.batch_depth) != (_MESH_WIDTH, depth):
                    # adopt between chunks: drain what the new depth
                    # cannot keep in flight, then re-shape
                    while len(pending) >= max(d.batch_depth, 1):
                        finish(pending.pop(0), self.overlap)
                    self.apply_scale(d)
        while pending:
            finish(pending.pop(0), self.overlap)
        timing.wall_s = time.perf_counter() - t_run - warm_s
        if self.detail == "windowed":
            agg, self._agg = self._agg.result(), None
            if self._obs is not None:
                self._obs.slo_attainment(
                    agg, self.tenants if self._tenanted else None)
            return FleetResult([], timing.camera_s, timing=timing,
                               stream_ids=list(agg.stream_ids),
                               decisions=decisions,
                               shapes=list(scaler.compiled_shapes),
                               aggregate=agg, served_cis=served_cis)
        served = [sid for sid in sorted(per_stream) if per_stream[sid]]
        streams = [RunResult(f"accmpeg_churn[{sid}]", per_stream[sid])
                   for sid in served]
        return FleetResult(streams, timing.camera_s, timing=timing,
                           stream_ids=served, decisions=decisions,
                           shapes=list(scaler.compiled_shapes),
                           served_cis=served_cis,
                           tenant_ids=[self._tenant_idx(sid)
                                       for sid in served]
                           if self._tenanted else None)
