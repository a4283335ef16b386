"""Typed fleet-engine configuration (port of ``repro.engine.config``).

The same frozen dataclass, field names and defaults as the reference's
``EngineConfig``. Fields whose subsystem this port does not have yet must
keep their defaults: setting one raises ``NotImplementedError`` naming
the slice that brings it (``ROADMAP.md``), rather than being ignored.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

from repro_torch.core.pipeline import NetworkConfig
from repro_torch.core.quality import QualityConfig

#: the accounting modes ``detail=`` accepts (validated here so a typo
#: fails at config build, before any engine exists)
DETAIL_MODES = ("chunks", "legacy", "windowed")

#: field -> (its default, the later slice that ports it)
_LATER = {
    "mesh": (None, "the multi-GPU slice (ROADMAP module 8)"),
    "trace": (None, "the control-plane slice (ROADMAP module 6)"),
    "controller": (None, "the control-plane slice (ROADMAP module 6)"),
    "autoscaler": (None, "the control-plane slice (ROADMAP module 6)"),
    "aggregate": (None, "the windowed-aggregation slice (ROADMAP module 6)"),
    "tenants": (None, "the tenants slice (ROADMAP module 7)"),
    "tenant_of": (None, "the tenants slice (ROADMAP module 7)"),
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
    ``detail="windowed"``, which come later."""

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
    aggregate: object = None
    device_reduce: bool = True
    tenants: Optional[Tuple] = None
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
        if self.detail == "windowed":
            raise NotImplementedError(
                "detail='windowed' is not ported yet: it comes with the "
                "windowed-aggregation slice (ROADMAP module 6)")
        for name, (default, slice_) in _LATER.items():
            if getattr(self, name) is not default:
                raise NotImplementedError(
                    f"EngineConfig.{name} is not ported yet: it comes with "
                    f"{slice_}; leave it at {default!r}")
