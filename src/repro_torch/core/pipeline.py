"""Delay/accuracy accounting for the camera -> network -> server path
(port of ``repro.core.pipeline``): per chunk, encoding delay (measured)
+ camera-side model overhead (measured) + streaming delay
(bytes * 8 / bandwidth + RTT/2). Server inference delay is excluded, as
in the paper. The chunk loop lives in :mod:`repro_torch.engine`."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.quality import QualityConfig


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """Per-stream constant network model."""

    bandwidth_bps: float = 2.5e6 / 5  # 5 streams share a 2.5 Mbps uplink
    rtt_s: float = 0.100


@dataclasses.dataclass
class ChunkResult:
    accuracy: float
    bytes: float
    encode_s: float
    overhead_s: float      # camera-side model cost (AccModel)
    stream_s: float
    extra_rtt_s: float = 0.0  # server feedback loops (baselines, later)
    queue_s: float = 0.0   # uplink backlog wait (trace mode, later)
    ci: int = -1           # absolute chunk-interval index

    @property
    def total_delay_s(self):
        return (self.encode_s + self.overhead_s + self.stream_s
                + self.extra_rtt_s + self.queue_s)


@dataclasses.dataclass
class RunResult:
    method: str
    chunks: List[ChunkResult]

    @property
    def accuracy(self):
        return float(np.mean([c.accuracy for c in self.chunks]))

    @property
    def mean_delay(self):
        return float(np.mean([c.total_delay_s for c in self.chunks]))

    @property
    def mean_bytes(self):
        return float(np.mean([c.bytes for c in self.chunks]))

    @property
    def p90_delay(self):
        return float(np.percentile([c.total_delay_s for c in self.chunks],
                                   90))

    def summary(self):
        c = self.chunks
        return {
            "method": self.method,
            "accuracy": self.accuracy,
            "delay_s": self.mean_delay,
            "p90_delay_s": self.p90_delay,
            "bytes_per_chunk": self.mean_bytes,
            "encode_s": float(np.mean([x.encode_s for x in c])),
            "overhead_s": float(np.mean([x.overhead_s for x in c])),
            "stream_s": float(np.mean([x.stream_s for x in c])),
            "extra_rtt_s": float(np.mean([x.extra_rtt_s for x in c])),
            "queue_s": float(np.mean([x.queue_s for x in c])),
        }


def stream_delay(n_bytes: float, net: NetworkConfig) -> float:
    return n_bytes * 8.0 / net.bandwidth_bps + net.rtt_s / 2.0


def make_reference(frames: np.ndarray, final_dnn, qp_hi: int = 30,
                   chunk_size: int = 10):
    """Per-chunk reference outputs D(H): the final DNN on the uniformly
    high-quality encoded video, on the DNN's device. Shared by every
    method in a comparison."""
    from repro_torch.codec.codec import encode_chunk_uniform

    refs = []
    T = frames.shape[0]
    for s in range(0, T - T % chunk_size, chunk_size):
        chunk = torch.as_tensor(frames[s : s + chunk_size],
                                device=final_dnn.device)
        hq, _ = encode_chunk_uniform(chunk, qp_hi)
        refs.append(final_dnn.predict(hq))
    return refs


def chunk_accuracy(final_dnn, decoded, hq_or_ref) -> float:
    out = final_dnn.predict(decoded)
    ref = hq_or_ref if isinstance(hq_or_ref, dict) \
        else final_dnn.predict(hq_or_ref)
    return final_dnn.accuracy(out, ref)


def run_accmpeg(frames: np.ndarray, accmodel, final_dnn,
                qcfg: QualityConfig = QualityConfig(),
                net: NetworkConfig = NetworkConfig(),
                chunk_size: int = 10, refs=None,
                frame_sample: Optional[int] = None) -> RunResult:
    """The AccMPEG camera loop, on the final DNN's device (thin wrapper
    over ``StreamingEngine.run(AccMPEGPolicy(...))``)."""
    from repro_torch.engine import AccMPEGPolicy, StreamingEngine

    policy = AccMPEGPolicy(accmodel, qcfg, frame_sample=frame_sample)
    engine = StreamingEngine(final_dnn, net=net, chunk_size=chunk_size,
                             device=final_dnn.device)
    return engine.run(policy, frames, refs=refs)
