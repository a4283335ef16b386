"""Typed fleet-engine configuration (port of ``repro.engine.config``).

The same frozen dataclass, field names and defaults as the reference's
``EngineConfig``, the multi-tenant plane (``tenants`` / ``tenant_of``)
included. The stream mesh, which this port does not have yet, must keep
its default: setting it raises ``NotImplementedError`` naming the slice
that brings it (``ROADMAP.md``), rather than being ignored.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

from repro_torch.core.aggregate import AggregateConfig
from repro_torch.core.pipeline import NetworkConfig
from repro_torch.core.quality import QualityConfig
from repro_torch.serve.tenants import TenantSpec, validate_tenants

#: the accounting modes ``detail=`` accepts (validated here so a typo
#: fails at config build, before any engine exists)
DETAIL_MODES = ("chunks", "legacy", "windowed")

#: field -> (its default, the later slice that ports it)
_LATER = {
    "mesh": (None, "the multi-GPU slice (ROADMAP module 8)"),
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Frozen serving configuration for :class:`~repro_torch.engine.
    multistream.MultiStreamEngine` (``MultiStreamEngine(dnn, accmodel,
    config=EngineConfig(...))``). Fields as in the reference: ``impl``
    names the chunk-encoder backend, ``overlap`` / ``depth`` the pipeline,
    ``detail`` the host accounting ("chunks" or "legacy" here),
    ``sim_encode_s`` a fixed accounted camera time. ``fps`` and
    ``device_reduce`` only matter with a trace and with
    ``detail="windowed"``.

    ``tenants``
        optional tuple of :class:`~repro_torch.serve.tenants.TenantSpec`.
        One tenant: the engine takes its DNN, AccModel and QualityConfig
        and serves the single-tenant path unchanged. Several: the fleet
        steps become tenant-routed (``serve.steps.make_tenant_*``).
    ``tenant_of``
        stream id -> index into ``tenants`` (default: tenant 0). It rides
        the engine as data, so a change of tenant mix at an admitted
        padded shape builds nothing new.
    """

    qcfg: QualityConfig = QualityConfig()
    net: Optional[NetworkConfig] = None
    chunk_size: int = 10
    impl: str = "fast"
    mesh: object = None
    overlap: bool = True
    depth: int = 2
    trace: object = None
    controller: object = None
    autoscaler: object = None
    fps: float = 30.0
    sim_encode_s: Optional[float] = None
    detail: str = "chunks"
    aggregate: Optional[AggregateConfig] = None
    device_reduce: bool = True
    tenants: Optional[Tuple[TenantSpec, ...]] = None
    tenant_of: Optional[Mapping[int, int]] = None

    def __post_init__(self):
        if self.detail not in DETAIL_MODES:
            raise ValueError(f"detail must be 'chunks', 'legacy', or "
                             f"'windowed', got {self.detail!r}")
        if self.chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got "
                             f"{self.chunk_size}")
        if self.depth < 1:
            raise ValueError(f"depth must be >= 1, got {self.depth}")
        for name, (default, slice_) in _LATER.items():
            if getattr(self, name) is not default:
                raise NotImplementedError(
                    f"EngineConfig.{name} is not ported yet: it comes with "
                    f"{slice_}; leave it at {default!r}")
        if self.tenants is not None:
            object.__setattr__(self, "tenants",
                               validate_tenants(self.tenants, self.impl))
        if self.tenant_of is not None:
            if self.tenants is None:
                raise ValueError("tenant_of without tenants: declare the "
                                 "TenantSpec tuple the ids index")
            n = len(self.tenants)
            tof = {}
            for sid, t in dict(self.tenant_of).items():
                if not 0 <= int(t) < n:
                    raise ValueError(f"tenant_of maps stream {sid} to "
                                     f"tenant {t}; config has {n} "
                                     f"tenants")
                tof[int(sid)] = int(t)
            object.__setattr__(self, "tenant_of", tof)

    @property
    def tenanted(self) -> bool:
        """True when the engine runs the tenant-routed fleet steps (two or
        more tenants; a single tenant folds into the single-DNN path)."""
        return self.tenants is not None and len(self.tenants) > 1
