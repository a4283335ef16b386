"""Delay/accuracy accounting for the camera -> network -> server path
(port of ``repro.core.pipeline``): per chunk, encoding delay (measured)
+ camera-side model overhead (measured) + streaming delay
(bytes * 8 / bandwidth + RTT/2). Server inference delay is excluded, as
in the paper. The chunk loops live in :mod:`repro_torch.engine`; a fleet
sharing one uplink is priced by processor sharing
(:func:`shared_stream_delays`) and its pipeline by :class:`FleetTiming`;
a time-varying uplink (``control.traces.NetworkTrace``) by
:class:`UplinkClock`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.quality import QualityConfig


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """Per-stream constant network model.

    ``bandwidth_bps`` is the bandwidth one stream sees. For fleets sharing
    one uplink, :meth:`shared` also records the total ``uplink_bps``, which
    the fleet engine prices by processor sharing
    (:func:`shared_stream_delays`) instead of a fixed equal split."""

    bandwidth_bps: float = 2.5e6 / 5  # 5 streams share a 2.5 Mbps uplink
    rtt_s: float = 0.100
    uplink_bps: Optional[float] = None  # total shared uplink (fleet mode)

    @classmethod
    def shared(cls, uplink_bps: float, n_streams: int, rtt_s: float = 0.100):
        """N streams fair-sharing one uplink."""
        return cls(bandwidth_bps=uplink_bps / n_streams, rtt_s=rtt_s,
                   uplink_bps=uplink_bps)


@dataclasses.dataclass
class ChunkResult:
    accuracy: float
    bytes: float
    encode_s: float
    overhead_s: float      # camera-side model cost (AccModel / heuristic)
    stream_s: float
    extra_rtt_s: float = 0.0  # server-driven feedback loops (DDS)
    queue_s: float = 0.0   # uplink backlog wait (trace mode)
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


@dataclasses.dataclass
class FleetTiming:
    """Wall-clock accounting for the pipelined fleet loop.

    Per chunk interval the fleet engine runs three stages: the camera step
    (device), the batched server DNN (device, enqueued without waiting)
    and host-side scoring (accuracy decode + uplink delays). With
    overlap, the host stage of chunk i runs while the device works on
    later chunks; ``wall_s`` is the measured makespan of the whole loop,
    ``serialized_s`` what the same stages cost back to back. Server
    inference stays out of per-stream *delay* (as in the paper): this
    tracks serving-tier throughput, not the camera SLO."""

    camera_s: List[float] = dataclasses.field(default_factory=list)
    server_s: List[float] = dataclasses.field(default_factory=list)
    host_s: List[float] = dataclasses.field(default_factory=list)
    wall_s: float = 0.0

    @property
    def serialized_s(self) -> float:
        return float(sum(self.camera_s) + sum(self.server_s)
                     + sum(self.host_s))

    @property
    def overlap_saving_s(self) -> float:
        return max(0.0, self.serialized_s - self.wall_s)

    @property
    def overlap_speedup(self) -> float:
        return self.serialized_s / max(self.wall_s, 1e-12)

    def summary(self) -> dict:
        return {
            "camera_s": float(np.sum(self.camera_s)),
            "server_s": float(np.sum(self.server_s)),
            "host_s": float(np.sum(self.host_s)),
            "wall_s": self.wall_s,
            "serialized_s": self.serialized_s,
            "overlap_speedup": self.overlap_speedup,
        }

    @staticmethod
    def merge_concurrent(timings: Sequence["FleetTiming"]) -> "FleetTiming":
        """Fold timings of fleets served in parallel into one view:
        ``wall_s`` is the slowest one's, the stage lists concatenate."""
        out = FleetTiming(wall_s=max((t.wall_s for t in timings),
                                     default=0.0))
        for t in timings:
            out.camera_s.extend(t.camera_s)
            out.server_s.extend(t.server_s)
            out.host_s.extend(t.host_s)
        return out


def pipeline_makespan(camera_s: Sequence[float],
                      server_s: Sequence[float]) -> float:
    """Two-stage pipeline lower bound: camera steps run back to back while
    each chunk's server step overlaps the next chunk's camera step. The
    fleet engine's measured ``FleetTiming.wall_s`` is bounded below by
    this."""
    cam_end = server_end = 0.0
    for c, s in zip(camera_s, server_s):
        cam_end += c
        server_end = max(cam_end, server_end) + s
    return server_end


def stream_delay(n_bytes: float, net: NetworkConfig) -> float:
    return n_bytes * 8.0 / net.bandwidth_bps + net.rtt_s / 2.0


def shared_stream_delays(stream_bytes: Sequence[float],
                         net: NetworkConfig) -> List[float]:
    """Completion time of N simultaneous uploads fair-sharing one uplink
    (processor sharing): every active stream gets an equal share; when a
    stream finishes, its share goes to the rest. Returns each stream's
    delay including RTT/2, in input order. The uplink is ``uplink_bps``,
    or ``bandwidth_bps * N`` when the config has none. The stable argsort
    keeps equal sizes in input order, and the cumulative sum adds the
    per-finish increments in that order, as the reference does."""
    n = len(stream_bytes)
    if n == 0:
        return []
    uplink = net.uplink_bps or net.bandwidth_bps * n
    b = np.asarray(stream_bytes, np.float64)
    order = np.argsort(b, kind="stable")
    bits = b[order] * 8.0
    prev = np.concatenate(([0.0], bits[:-1]))
    inc = (bits - prev) * (n - np.arange(n, dtype=np.float64)) / uplink
    t = np.cumsum(inc)
    delays = np.empty(n, np.float64)
    delays[order] = t + net.rtt_s / 2.0
    return delays.tolist()


class UplinkClock:
    """Trace-aware delay accounting for one camera uplink (or one fleet's
    shared uplink).

    The constant-bandwidth model prices every chunk on its own
    (:func:`stream_delay`). With a time-varying trace
    (:class:`repro_torch.control.traces.NetworkTrace`, duck-typed here)
    two effects matter, and this clock owns both: the transmit time
    depends on *when* the upload starts (``trace.transmit_time``
    integrates rate over the trace), and chunk ``ci+1`` cannot start
    uploading until chunk ``ci`` has left the uplink, so during a fade the
    backlog queues and the wait is charged as ``queue_s``.

    Chunk ``ci`` is captured at ``ci * chunk_size / fps`` (a live camera,
    not a file read); it is ready to send after its camera-side compute
    (``ready_s``), and starts as soon as the uplink is free.
    """

    def __init__(self, trace, chunk_size: int = 10, fps: float = 30.0):
        self.trace = trace
        self.chunk_wall_s = chunk_size / fps
        self.free_at_s = 0.0

    def capture_s(self, ci: int) -> float:
        return ci * self.chunk_wall_s

    def send(self, ci: int, n_bytes: float, ready_s: float):
        """One stream's transmission -> ``(stream_s, queue_s)``.
        ``stream_s`` (transmit + RTT/2) means what :func:`stream_delay`
        means; ``queue_s`` is the uplink-busy wait before it."""
        ready = self.capture_s(ci) + ready_s
        start = max(ready, self.free_at_s)
        dt = self.trace.transmit_time(n_bytes, start)
        self.free_at_s = start + dt
        return dt + self.trace.rtt_s / 2.0, start - ready

    def send_shared(self, ci: int, stream_bytes: Sequence[float],
                    ready_s: float):
        """Fleet variant: N chunk uploads start together and
        processor-share the uplink (``trace.shared_transmit_times``).
        Returns ``(per-stream stream_s list, queue_s)``; the queue wait is
        common to the batch."""
        ready = self.capture_s(ci) + ready_s
        start = max(ready, self.free_at_s)
        durs = np.asarray(
            self.trace.shared_transmit_times(stream_bytes, start),
            np.float64)
        self.free_at_s = start + (float(durs.max()) if durs.size else 0.0)
        return (durs + self.trace.rtt_s / 2.0).tolist(), start - ready


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
