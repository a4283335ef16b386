"""Counter / gauge / histogram registry with JSONL and Prometheus export.

A copy of ``repro.obs.metrics`` (numpy only), so that the port needs
nothing of ``repro``.

The numeric half of the telemetry plane (:mod:`repro_torch.obs.trace` is the
timeline half): engines and the control plane record *what happened per
interval* — stage seconds, uplink backlog depth, active/padded lane
counts, controller level moves, admission outcomes, compile-cache sizes
— into one process-wide registry, exportable as JSONL (one sample per
line, machine-diffable) or Prometheus text format (scrapeable).

Same constraints as the tracer:

- **Zero-cost when disabled**: the ambient registry is ``None`` by
  default; hot loops hoist :func:`get_metrics` and branch once.
- **Never perturb the data path**: recording is pure host-side float
  arithmetic on values the engine already computed.
- **Mergeable across hosts**: counters and histogram bucket counts add;
  :meth:`Histogram.merge` is associative and commutative (pinned by
  property tests), so the fleet-level view is independent of gather
  order — the same contract ``core.aggregate``'s windowed path keeps
  for its tier-attainment ``bincount`` counters.

Histograms are **fixed-bucket**: boundaries are chosen at creation
(default: a log-spaced latency ladder) and never move, which is what
makes cross-host merge exact — unlike quantile sketches, the merged
histogram is bit-identical to one host having observed everything.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: default histogram ladder: log-spaced seconds from 100µs to ~100s —
#: wide enough for camera steps (ms) and uplink queue spikes (tens of s)
DEFAULT_BUCKETS = tuple(float(b) for b in np.logspace(-4, 2, 25))


def _label_key(labels: Optional[dict]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v))
                        for k, v in (labels or {}).items()))


@dataclasses.dataclass
class Counter:
    """Monotonically increasing count (events, bytes, cache hits)."""

    name: str
    value: float = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc by {amount})")
        self.value += amount

    def sample(self) -> dict:
        return {"type": "counter", "value": self.value}


@dataclasses.dataclass
class Gauge:
    """Last-write-wins instantaneous value (lane counts, backlog)."""

    name: str
    value: float = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def sample(self) -> dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed-bucket histogram: counts of observations ≤ each boundary
    (cumulative on export, per-bucket internally), plus exact sum/count.

    ``boundaries`` are the inclusive upper edges; one implicit +inf
    bucket catches the rest. Merging histograms with identical
    boundaries adds their bucket counts — exact, associative,
    commutative — which is the property that lets per-host telemetry
    reduce to a fleet view in any gather order.
    """

    def __init__(self, name: str,
                 boundaries: Sequence[float] = DEFAULT_BUCKETS):
        if not boundaries or list(boundaries) != sorted(boundaries):
            raise ValueError("histogram boundaries must be a non-empty "
                             "ascending sequence")
        self.name = name
        self.boundaries = tuple(float(b) for b in boundaries)
        self._edges = np.asarray(self.boundaries, np.float64)
        self.counts = np.zeros(len(self.boundaries) + 1, np.int64)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.counts[int(np.searchsorted(self._edges, value, "left"))] += 1
        self.sum += float(value)
        self.count += 1

    def observe_many(self, values) -> None:
        v = np.asarray(values, np.float64)
        if v.size == 0:
            return
        self.counts += np.bincount(
            np.searchsorted(self._edges, v, "left"),
            minlength=self.counts.size).astype(np.int64)
        self.sum += float(v.sum())
        self.count += int(v.size)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile (upper boundary of the bucket the
        q-th observation falls in; +inf bucket reports the top edge)."""
        if not self.count:
            return float("nan")
        target = q * self.count
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, target, "left"))
        return self.boundaries[min(i, len(self.boundaries) - 1)]

    def merge(self, other: "Histogram") -> "Histogram":
        """Pure merged copy (neither operand mutated)."""
        if self.boundaries != other.boundaries:
            raise ValueError(
                f"cannot merge histograms with different boundaries "
                f"({self.name}: {len(self.boundaries)} edges vs "
                f"{other.name}: {len(other.boundaries)})")
        out = Histogram(self.name, self.boundaries)
        out.counts = self.counts + other.counts
        out.sum = self.sum + other.sum
        out.count = self.count + other.count
        return out

    def sample(self) -> dict:
        return {"type": "histogram", "count": self.count,
                "sum": self.sum, "boundaries": list(self.boundaries),
                "counts": self.counts.tolist()}


class MetricsRegistry:
    """Named metric store (get-or-create accessors, like Prometheus
    client registries). Labels are plain dicts folded into the metric
    key, so ``counter("x", stage="camera")`` and
    ``counter("x", stage="server")`` are independent series."""

    def __init__(self, host: int = 0):
        self.host = int(host)
        self._metrics: Dict[tuple, object] = {}
        self._lock = threading.Lock()

    def _get(self, kind, name: str, labels: dict, factory):
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = factory()
                self._metrics[key] = m
            elif not isinstance(m, kind):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, not {kind.__name__}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels, lambda: Counter(name))

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels, lambda: Gauge(name))

    def histogram(self, name: str,
                  boundaries: Sequence[float] = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels,
                         lambda: Histogram(name, boundaries))

    # -- introspection ---------------------------------------------------
    def series(self) -> List[dict]:
        """Every metric as ``{"name", "labels", **sample}`` dicts,
        sorted by (name, labels) so exports are deterministic."""
        with self._lock:
            items = sorted(self._metrics.items())
        return [{"name": name, "labels": dict(labels), **m.sample()}
                for (name, labels), m in items]

    def get(self, name: str, **labels):
        """Lookup without creating; None when the series never fired."""
        return self._metrics.get((name, _label_key(labels)))

    # -- exporters -------------------------------------------------------
    def to_jsonl(self) -> str:
        """One JSON object per line per series (host + unix timestamp
        stamped), ready for ``jq``/pandas or append-only log files."""
        ts = time.time()
        return "\n".join(
            json.dumps({"host": self.host, "unix_time": ts, **s},
                       sort_keys=True)
            for s in self.series())

    def write_jsonl(self, path) -> None:
        text = self.to_jsonl()
        with open(path, "w") as f:
            f.write(text + ("\n" if text else ""))

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (counters get ``_total``,
        histograms the ``_bucket``/``_sum``/``_count`` triplet with
        cumulative ``le`` buckets)."""
        lines: List[str] = []
        for s in self.series():
            labels = dict(s["labels"])
            base = _fmt_labels(labels)
            name = s["name"]
            if s["type"] == "counter":
                lines.append(f"# TYPE {name}_total counter")
                lines.append(f"{name}_total{base} {_fmt(s['value'])}")
            elif s["type"] == "gauge":
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name}{base} {_fmt(s['value'])}")
            else:
                lines.append(f"# TYPE {name} histogram")
                cum = 0
                for b, c in zip(s["boundaries"], s["counts"]):
                    cum += c
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(dict(labels, le=_fmt(b)))} {cum}")
                cum += s["counts"][-1]
                lines.append(
                    f"{name}_bucket"
                    f"{_fmt_labels(dict(labels, le='+Inf'))} {cum}")
                lines.append(f"{name}_sum{base} {_fmt(s['sum'])}")
                lines.append(f"{name}_count{base} {s['count']}")
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt(v: float) -> str:
    return repr(float(v)) if v != int(v) else str(int(v))


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + body + "}"


# ---------------------------------------------------------------------------
# the ambient registry (module-level singleton; None = disabled)
# ---------------------------------------------------------------------------
_METRICS: Optional[MetricsRegistry] = None


def get_metrics() -> Optional[MetricsRegistry]:
    """The ambient registry, or ``None`` when metrics are disabled.
    Hot loops call once per run and branch on ``is not None``."""
    return _METRICS


def enabled() -> bool:
    return _METRICS is not None


def install(registry: Optional[MetricsRegistry] = None,
            host: int = 0) -> MetricsRegistry:
    global _METRICS
    _METRICS = registry if registry is not None \
        else MetricsRegistry(host=host)
    return _METRICS


def uninstall() -> Optional[MetricsRegistry]:
    global _METRICS
    m, _METRICS = _METRICS, None
    return m
