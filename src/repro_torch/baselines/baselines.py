"""Baselines from the paper's five categories (§6.1), port of
``repro.baselines.baselines``; all run through the same StreamingEngine
(codec + network + accuracy accounting) as AccMPEG:

- AWStream (idealized): uniform QP per chunk; a benchmark sweeps QP and
  reports the profile (the paper grants AWStream a free profiling pass).
- DDS: server-driven two-pass: low-QP pass to the server, the server
  returns regions (from the *final DNN*'s detections), those re-encoded in
  high quality; pays both streams + an extra RTT.
- EAAR: region proposals from the previous chunk's server inference drive
  the current chunk's RoI (1 chunk of staleness, no second stream).
- Reducto: camera-side frame differencing; below-threshold frames are
  dropped (the server reuses the last result); sent frames are uniform QP.
- Vigil: cheap camera-side detector; bounding-box regions high quality,
  background at QP 51.

Each method is a QPPolicy in :mod:`repro_torch.engine.policies`; the
``run_*`` functions here are thin wrappers. Each runs on ``device``
(default ``"cuda"``, which raises where there is no card).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.pipeline import NetworkConfig, RunResult
from repro_torch.engine import (DDSPolicy, EAARPolicy, ReductoPolicy,
                                StreamingEngine, UniformPolicy, VigilPolicy,
                                boxes_to_mask, frame_diff_feature)

__all__ = ["boxes_to_mask", "frame_diff_feature", "run_dds", "run_eaar",
           "run_reducto", "run_uniform", "run_vigil"]


def _run(policy, frames, final_dnn, net, chunk_size, refs,
         device) -> RunResult:
    engine = StreamingEngine(final_dnn, net=net, chunk_size=chunk_size,
                             device=device)
    return engine.run(policy, frames, refs=refs)


def run_uniform(frames, final_dnn, qp: int,
                net: NetworkConfig = NetworkConfig(), chunk_size: int = 10,
                method: Optional[str] = None, refs=None,
                device="cuda") -> RunResult:
    """AWStream-idealized building block: one uniform QP."""
    return _run(UniformPolicy(qp, name=method), frames, final_dnn, net,
                chunk_size, refs, device)


def run_dds(frames, final_dnn, qp_hi=30, qp_lo=40, grow=1,
            net: NetworkConfig = NetworkConfig(), chunk_size: int = 10,
            refs=None, device="cuda") -> RunResult:
    """Server-driven two-pass (the final DNN itself produces the feedback)."""
    return _run(DDSPolicy(qp_hi=qp_hi, qp_lo=qp_lo, grow=grow), frames,
                final_dnn, net, chunk_size, refs, device)


def run_eaar(frames, final_dnn, qp_hi=30, qp_lo=40, grow=2,
             net: NetworkConfig = NetworkConfig(), chunk_size: int = 10,
             refs=None, device="cuda") -> RunResult:
    """Previous chunk's server detections drive the current RoI."""
    return _run(EAARPolicy(qp_hi=qp_hi, qp_lo=qp_lo, grow=grow), frames,
                final_dnn, net, chunk_size, refs, device)


def run_reducto(frames, final_dnn, qp=32, thresh=0.05,
                net: NetworkConfig = NetworkConfig(), chunk_size: int = 10,
                refs=None, device="cuda") -> RunResult:
    return _run(ReductoPolicy(qp=qp, thresh=thresh), frames, final_dnn, net,
                chunk_size, refs, device)


def run_vigil(frames, final_dnn, camera_detector, qp_hi=30, qp_lo=51, grow=0,
              net: NetworkConfig = NetworkConfig(), chunk_size: int = 10,
              refs=None, device="cuda") -> RunResult:
    """Cheap camera detector -> box regions hi, background effectively
    dropped (QP 51). camera_detector: a FinalDNN-like cheap model."""
    return _run(VigilPolicy(camera_detector, qp_hi=qp_hi, qp_lo=qp_lo,
                            grow=grow), frames, final_dnn, net, chunk_size,
                refs, device)
