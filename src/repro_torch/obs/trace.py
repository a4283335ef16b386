"""Span tracing for the serving pipeline — Chrome trace-event output.

A copy of ``repro.obs.trace`` (standard library only), so that the port
needs nothing of ``repro``.

AccMPEG's claims are end-to-end latency claims, yet the engines only
report *aggregate* numbers (``FleetTiming`` sums, ``p90_delay``). This
tracer records *where* each interval's time went — one span per pipeline
stage per chunk interval, explicit instants for control-plane decisions
(rate-controller level moves, autoscaler decide/admit, churn, encoder
fallbacks) — and serializes to the Chrome trace-event JSON format, so a
run opens directly in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``.

Design constraints, in order:

1. **Zero-cost when disabled.** Tracing is off by default; the ambient
   tracer is ``None`` and hot loops hoist ``get_tracer()`` out of the
   per-chunk path, so the disabled cost is one ``is not None`` test per
   interval.
2. **Never perturb the data path.** Spans are recorded from timestamps
   the engine *already takes* for its own accounting
   (:meth:`Tracer.complete` takes caller-measured begin/duration) — no
   extra device synchronisation, no RNG. Telemetry-on
   vs telemetry-off ``FleetResult``s are bit-identical (pinned by
   ``tests/test_torch_obs.py``).
3. **Merge across hosts.** Each tracer stamps a wall-clock anchor at
   creation; :func:`merge_host_traces` aligns every host's monotonic
   spans onto one global timeline (one Chrome *process* lane per host,
   one *thread* lane per pipeline stage). Multi-host serving, which
   ships spans between hosts, comes with the port's module 8.

Timeline layout: ``pid`` = host id, ``tid`` = stage lane. The stage
vocabulary (:data:`STAGES`) covers the serving pipeline — camera step,
server step, uplink transmit, host scoring, admission, controller,
warm-up/compile — and instants land on the lane of the stage that
caused them.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Dict, List, Optional, Sequence

#: pipeline-stage lanes, in display order (Chrome sorts by the
#: thread_sort_index metadata emitted alongside the spans)
STAGES = ("camera", "server", "uplink", "scoring", "admission",
          "controller", "autoscaler", "warmup", "events")


@dataclasses.dataclass
class SpanEvent:
    """One trace event on the monotonic clock (seconds).

    ``phase`` follows the Chrome trace-event vocabulary: ``"X"`` is a
    complete span (``ts`` + ``dur``), ``"i"`` an instant. ``args`` must
    be JSON-serializable — it crosses hosts on the fleet wire.
    """

    name: str
    stage: str
    ts: float               # monotonic seconds (perf_counter domain)
    dur: float = 0.0        # seconds; 0 for instants
    phase: str = "X"
    args: Optional[dict] = None

    def to_wire(self) -> dict:
        return {"name": self.name, "stage": self.stage, "ts": self.ts,
                "dur": self.dur, "phase": self.phase, "args": self.args}

    @classmethod
    def from_wire(cls, d: dict) -> "SpanEvent":
        return cls(**d)


class _SpanCtx:
    """Context manager recording one complete span around a block."""

    __slots__ = ("_tracer", "_name", "_stage", "_args", "_t0")

    def __init__(self, tracer, name, stage, args):
        self._tracer = tracer
        self._name = name
        self._stage = stage
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._tracer.complete(self._name, self._stage, self._t0,
                              t1 - self._t0, **(self._args or {}))
        return False


class _NullSpan:
    """Shared no-op context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """In-memory span store for one process (one fleet host).

    All record methods are append-only on a plain list under a lock
    (the engines call from one thread, but callbacks may not) —
    no I/O, no allocation beyond the event record, so the enabled-path
    cost stays well under the <2% overhead budget.

    ``host`` is the Chrome *process* lane. ``wall_anchor`` pairs one
    ``time.time()`` sample with one ``time.perf_counter()`` sample at
    construction: monotonic clocks are process-local, so cross-host
    alignment maps each host's span times onto the shared wall clock
    (``wall = ts - anchor_mono + anchor_wall``). NTP-grade skew remains
    (milliseconds); stage *durations* are exact regardless.
    """

    def __init__(self, host: int = 0):
        self.host = int(host)
        self.events: List[SpanEvent] = []
        self._lock = threading.Lock()
        self.anchor_wall = time.time()
        self.anchor_mono = time.perf_counter()

    # -- recording ------------------------------------------------------
    def complete(self, name: str, stage: str, t0: float, dur: float,
                 **args) -> None:
        """Record a finished span from caller-measured times (the hot
        path: the engine already holds these timestamps for its own
        accounting, so tracing adds no clock reads)."""
        ev = SpanEvent(name, stage, t0, dur, "X", args or None)
        with self._lock:
            self.events.append(ev)

    def instant(self, name: str, stage: str = "events", **args) -> None:
        """Record a point event (decision, churn, fallback warning)."""
        ev = SpanEvent(name, stage, time.perf_counter(), 0.0, "i",
                       args or None)
        with self._lock:
            self.events.append(ev)

    def span(self, name: str, stage: str = "events",
             **args) -> _SpanCtx:
        """Context manager measuring a block as one complete span."""
        return _SpanCtx(self, name, stage, args)

    # -- serialization --------------------------------------------------
    def payload(self) -> dict:
        """This host's spans + clock anchor, JSON-ready for the fleet
        allgather (one per host)."""
        with self._lock:
            events = [e.to_wire() for e in self.events]
        return {"host": self.host, "anchor_wall": self.anchor_wall,
                "anchor_mono": self.anchor_mono, "events": events}

    def adopt(self, payload: dict) -> None:
        """Fold another host's gathered payload into this store (events
        keep their origin host via the merge; adopting your own host's
        payload back is skipped so the gather round-trip never
        duplicates)."""
        if int(payload["host"]) == self.host:
            return
        with self._lock:
            self._adopted = getattr(self, "_adopted", [])
            self._adopted.append(payload)

    def chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object for this host's spans plus
        any adopted peers' — load in Perfetto / chrome://tracing."""
        payloads = [self.payload()] + list(getattr(self, "_adopted", []))
        return merge_host_traces(payloads)

    def write(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    # -- introspection (tests, summaries) -------------------------------
    def stage_events(self, stage: str) -> List[SpanEvent]:
        with self._lock:
            return [e for e in self.events if e.stage == stage]

    def clear(self) -> None:
        with self._lock:
            self.events = []
            self._adopted = []


def merge_host_traces(payloads: Sequence[dict]) -> dict:
    """Assemble gathered per-host span payloads into one Chrome
    trace-event JSON object: one process lane per host (named
    ``host<h>``), one thread lane per pipeline stage, all timestamps
    aligned onto the shared wall clock via each host's anchor pair.

    The earliest wall time across hosts becomes t=0 so the timeline
    starts at the origin regardless of when the fleet booted.
    """
    payloads = sorted(payloads, key=lambda p: int(p["host"]))
    hosts = [int(p["host"]) for p in payloads]
    if len(set(hosts)) != len(hosts):
        raise ValueError(f"two trace payloads claim the same host lane: "
                         f"{hosts}")
    # wall-clock alignment: ts_wall = ts_mono - anchor_mono + anchor_wall
    t0 = min((p["anchor_wall"] - p["anchor_mono"]
              + min((e["ts"] for e in p["events"]),
                    default=p["anchor_mono"]))
             for p in payloads) if payloads else 0.0
    trace_events: List[dict] = []
    stage_tid = {s: i for i, s in enumerate(STAGES)}
    for p in payloads:
        host = int(p["host"])
        off = p["anchor_wall"] - p["anchor_mono"] - t0
        trace_events.append({"ph": "M", "pid": host, "tid": 0,
                             "name": "process_name",
                             "args": {"name": f"host{host}"}})
        seen_stages = sorted({e["stage"] for e in p["events"]},
                             key=lambda s: stage_tid.get(s, len(STAGES)))
        for s in seen_stages:
            tid = stage_tid.get(s, len(STAGES))
            trace_events.append({"ph": "M", "pid": host, "tid": tid,
                                 "name": "thread_name",
                                 "args": {"name": s}})
            trace_events.append({"ph": "M", "pid": host, "tid": tid,
                                 "name": "thread_sort_index",
                                 "args": {"sort_index": tid}})
        for e in p["events"]:
            tid = stage_tid.get(e["stage"], len(STAGES))
            rec = {"name": e["name"], "ph": e["phase"], "pid": host,
                   "tid": tid, "ts": (e["ts"] + off) * 1e6}
            if e["phase"] == "X":
                rec["dur"] = e["dur"] * 1e6
            if e["phase"] == "i":
                rec["s"] = "t"  # instant scope: thread
            if e.get("args"):
                rec["args"] = e["args"]
            trace_events.append(rec)
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def stage_summary(payloads: Sequence[dict]) -> Dict[int, Dict[str, dict]]:
    """Per-host, per-stage span statistics from gathered payloads —
    ``{host: {stage: {n, total_s, mean_s, max_s}}}``."""
    out: Dict[int, Dict[str, dict]] = {}
    for p in sorted(payloads, key=lambda q: int(q["host"])):
        stages: Dict[str, dict] = {}
        for e in p["events"]:
            if e["phase"] != "X":
                continue
            s = stages.setdefault(e["stage"],
                                  {"n": 0, "total_s": 0.0, "max_s": 0.0})
            s["n"] += 1
            s["total_s"] += e["dur"]
            s["max_s"] = max(s["max_s"], e["dur"])
        for s in stages.values():
            s["mean_s"] = s["total_s"] / max(s["n"], 1)
        out[int(p["host"])] = stages
    return out


# ---------------------------------------------------------------------------
# the ambient tracer (module-level singleton; None = disabled)
# ---------------------------------------------------------------------------
_TRACER: Optional[Tracer] = None


def get_tracer() -> Optional[Tracer]:
    """The ambient tracer, or ``None`` when tracing is disabled. Hot
    loops call this once per run and branch on ``is not None`` — that
    one test is the entire disabled-path cost."""
    return _TRACER


def enabled() -> bool:
    return _TRACER is not None


def install(tracer: Optional[Tracer] = None, host: int = 0) -> Tracer:
    """Enable tracing (idempotent: re-installing replaces the store)."""
    global _TRACER
    _TRACER = tracer if tracer is not None else Tracer(host=host)
    return _TRACER


def uninstall() -> Optional[Tracer]:
    """Disable tracing; returns the tracer that was active (its spans
    stay readable after uninstall — flush then drop)."""
    global _TRACER
    t, _TRACER = _TRACER, None
    return t


def span(name: str, stage: str = "events", **args):
    """Ambient span: a real span when tracing is enabled, a shared
    no-op context manager otherwise. Convenient for warm-up / one-shot
    paths; per-chunk hot loops should hoist ``get_tracer()`` instead."""
    t = _TRACER
    return t.span(name, stage, **args) if t is not None else _NULL_SPAN


def instant(name: str, stage: str = "events", **args) -> None:
    """Ambient instant; no-op when disabled."""
    t = _TRACER
    if t is not None:
        t.instant(name, stage, **args)
