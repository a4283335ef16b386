"""Single-stream control plane of the port (from ``repro.control``):

- :mod:`repro_torch.control.traces`: seeded, genre-based time-varying
  bandwidth traces (``NetworkTrace`` and the lte / wifi / drone
  generators) and their transmit-time solvers, which replace the constant
  ``stream_delay`` under ``StreamingEngine(trace=...)``.
- :mod:`repro_torch.control.controller`: the per-stream AIMD
  ``RateController`` that sets encode knobs (qp_hi / qp_lo, AccModel
  threshold, frame-drop threshold) per chunk from observed delay and
  backlog, and ``ControlledAccMPEGPolicy``, which reads them as a tensor
  on the device.

The fleet's half (autoscaler, workloads) is not ported yet
(``ROADMAP.md``, module 6).
"""
from repro_torch.control.controller import (ChunkObservation, ControlKnobs,
                                            ControlledAccMPEGPolicy,
                                            RateController)
from repro_torch.control.traces import (NetworkTrace, TRACE_GENRES,
                                        constant_trace, drone_trace,
                                        lte_trace, make_trace, wifi_trace)

__all__ = [
    "ChunkObservation", "ControlKnobs", "ControlledAccMPEGPolicy",
    "NetworkTrace", "RateController", "TRACE_GENRES", "constant_trace",
    "drone_trace", "lte_trace", "make_trace", "wifi_trace",
]
