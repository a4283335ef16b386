"""Control plane of the port (from ``repro.control``):

- :mod:`repro_torch.control.traces`: seeded, genre-based time-varying
  bandwidth traces (``NetworkTrace`` and the lte / wifi / drone
  generators) and their transmit-time solvers, which replace the constant
  ``stream_delay`` under ``StreamingEngine(trace=...)`` and
  ``EngineConfig(trace=...)``.
- :mod:`repro_torch.control.controller`: the AIMD ``RateController``
  that sets encode knobs (qp_hi / qp_lo, AccModel threshold, frame-drop
  threshold) per chunk from observed delay and backlog, and
  ``ControlledAccMPEGPolicy``, which reads them as a tensor on the
  device.
- :mod:`repro_torch.control.autoscaler`: the ``FleetAutoscaler`` that
  turns ``FleetTiming`` stage occupancies into batch-depth decisions,
  with admission control that pads stream joins/leaves to fleet shapes
  already served, and the churn vocabulary (``ChurnEvent``,
  ``apply_churn``) of ``MultiStreamEngine.serve_loop``.
- :mod:`repro_torch.control.workload`: seeded open-loop churn schedules
  (``make_workload``).

``CrossHostAutoscaler`` comes with the multi-host slice (ROADMAP module
8).
"""
from repro_torch.control.autoscaler import (AdmissionPlan, ChurnEvent,
                                            FleetAutoscaler, ScaleDecision,
                                            apply_churn, pad_streams)
from repro_torch.control.controller import (ChunkObservation, ControlKnobs,
                                            ControlledAccMPEGPolicy,
                                            RateController)
from repro_torch.control.traces import (NetworkTrace, TRACE_GENRES,
                                        constant_trace, drone_trace,
                                        lte_trace, make_trace, wifi_trace)
from repro_torch.control.workload import Workload, make_workload

__all__ = [
    "AdmissionPlan", "ChunkObservation", "ChurnEvent", "ControlKnobs",
    "ControlledAccMPEGPolicy", "FleetAutoscaler", "NetworkTrace",
    "RateController", "ScaleDecision", "TRACE_GENRES", "Workload",
    "apply_churn", "constant_trace", "drone_trace", "lte_trace",
    "make_trace", "make_workload", "pad_streams", "wifi_trace",
]
