"""repro_torch.obs — the fleet telemetry plane (port of ``repro.obs``).

Three cooperating pieces, all zero-cost when disabled and all fed by
values the serving path already computes (telemetry never perturbs the
data path — telemetry-on vs -off ``FleetResult``s are bit-identical):

- :mod:`repro_torch.obs.trace` — span tracer: per-stage spans per chunk
  interval, instants for control-plane decisions, Chrome trace-event
  JSON output (Perfetto-loadable), cross-host merge with wall-clock
  alignment (a copy of the reference's).
- :mod:`repro_torch.obs.metrics` — counter/gauge/histogram registry
  with JSONL and Prometheus-text exporters; fixed-bucket histograms
  merge exactly across hosts (a copy of the reference's).
- :mod:`repro_torch.obs.compile` — what the fleet engine builds per
  padded shape (``CompileCounter``), so new warm-ups surface as live
  metrics and timeline instants.
- :mod:`repro_torch.obs.profiler` — ``profile_region``, the launchers'
  ``torch.profiler`` wiring for one process (the cross-host merge comes
  with ROADMAP module 8).

:func:`enable` / :func:`disable` flip the whole plane at once;
``REPRO_OBS=1`` in the environment enables it through
:func:`enable_from_env`.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

from repro_torch.obs import metrics as metrics
from repro_torch.obs import trace as trace
from repro_torch.obs.compile import CompileCounter
from repro_torch.obs.metrics import (DEFAULT_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry,
                                     get_metrics)
from repro_torch.obs.profiler import profile_region
from repro_torch.obs.trace import (STAGES, SpanEvent, Tracer, get_tracer,
                                   merge_host_traces, stage_summary)

#: environment opt-in read by :func:`enable_from_env` — the way a gang of
#: fleet workers agrees to enable telemetry together
ENV_OBS = "REPRO_OBS"


def enable(host: int = 0) -> Tuple[Tracer, MetricsRegistry]:
    """Install the ambient tracer and metrics registry (host = this
    process's fleet lane). Idempotent in effect: re-enabling replaces
    both stores with fresh ones."""
    return trace.install(host=host), metrics.install(host=host)


def disable() -> Tuple[Optional[Tracer], Optional[MetricsRegistry]]:
    """Uninstall both; returns the stores that were active (still
    readable — flush exports after disabling)."""
    return trace.uninstall(), metrics.uninstall()


def enabled() -> bool:
    return trace.enabled() or metrics.enabled()


def enable_from_env(host: int = 0) -> bool:
    """Enable the plane when ``REPRO_OBS`` is set truthy; returns
    whether it is now enabled."""
    if os.environ.get(ENV_OBS, "").lower() in ("1", "true", "yes", "on"):
        enable(host=host)
    return enabled()


__all__ = [
    "CompileCounter", "Counter", "DEFAULT_BUCKETS", "ENV_OBS", "Gauge",
    "Histogram", "MetricsRegistry", "STAGES", "SpanEvent", "Tracer",
    "disable", "enable", "enable_from_env", "enabled", "get_metrics",
    "get_tracer", "merge_host_traces", "metrics", "profile_region",
    "stage_summary", "trace",
]
