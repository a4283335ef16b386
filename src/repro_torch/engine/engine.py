"""StreamingEngine: the single camera -> network -> server chunk loop
(port of ``repro.engine.engine``). Every method of the paper's comparison
(AccMPEG, its rate-controlled variant and the baselines) is a small
:class:`~repro_torch.engine.policies.QPPolicy`; the engine owns the
accounting, so all of them share it:

    per chunk:  encode delay (measured wall-clock)
              + camera-side model overhead (measured)
              + streaming delay (bytes * 8 / bandwidth + RTT/2 per
                transmission, or the trace's transmit time and queue)
              + extra server RTTs (server-driven methods, e.g. DDS)

Server inference delay is excluded, as in the paper. Timed regions end in
``torch.cuda.synchronize()`` on CUDA, so they measure the device's work
and not its enqueue.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import torch

from repro_torch import resolve_device, synchronize
from repro_torch.codec.codec import CHUNK_ENCODERS, encode_chunk_uniform
from repro_torch.core.pipeline import (ChunkResult, NetworkConfig, RunResult,
                                       UplinkClock, chunk_accuracy,
                                       stream_delay)


def jit_encode(impl: str = "exact"):
    """The RoI chunk encoder ``impl`` from ``codec.CHUNK_ENCODERS``. PyTorch
    runs eagerly, so this is a registry lookup; the name is kept from the
    reference, whose version compiled the encoder."""
    return CHUNK_ENCODERS.resolve(impl)


class ChunkContext:
    """Per-chunk execution context handed to ``QPPolicy.encode_chunk``:
    owns timing and byte accounting. Camera-side model work goes through
    :meth:`time_overhead`, every encode through :meth:`encode` /
    :meth:`encode_uniform` (each is one transmission), server-feedback
    waits through :meth:`add_server_rtt`. Server inference itself
    (:meth:`server_predict`) is untimed, as in the paper."""

    def __init__(self, engine: "StreamingEngine", ci: int,
                 chunk: torch.Tensor):
        self.engine = engine
        self.server = engine.final_dnn
        self.ci = ci
        self.chunk = chunk
        self.encode_s = 0.0
        self.overhead_s = 0.0
        self.extra_rtt_s = 0.0
        self.transmissions: List[float] = []

    def time_overhead(self, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        synchronize(self.engine.device)
        self.overhead_s += time.perf_counter() - t0
        return out

    def _timed_encode(self, fn, *args):
        t0 = time.perf_counter()
        decoded, pbytes = fn(*args)
        synchronize(self.engine.device)
        self.encode_s += time.perf_counter() - t0
        self.transmissions.append(float(pbytes.sum()))
        return decoded

    def encode(self, qp_maps: torch.Tensor, frames=None) -> torch.Tensor:
        """RoI-encode ``frames`` (default: the chunk) with per-macroblock
        QP maps (T or 1 leading) through the engine's ``impl`` backend;
        one transmission on the wire."""
        frames = self.chunk if frames is None else frames
        return self._timed_encode(jit_encode(self.engine.impl), frames,
                                  qp_maps)

    def encode_uniform(self, qp: int, frames=None) -> torch.Tensor:
        frames = self.chunk if frames is None else frames
        return self._timed_encode(encode_chunk_uniform, frames, qp)

    def add_server_rtt(self):
        """Charge one camera<->server round trip (server-driven methods).
        In trace mode the trace defines the network, so its RTT is
        charged."""
        self.extra_rtt_s += self.engine.net.rtt_s \
            if self.engine.trace is None else self.engine.trace.rtt_s

    def server_predict(self, decoded):
        """Run the final DNN (server side, excluded from delay)."""
        return self.server.predict(decoded)


class StreamingEngine:
    """Runs any QPPolicy through the shared chunk loop on ``device``.

    ``impl`` names the ``codec.CHUNK_ENCODERS`` backend for every
    ``ctx.encode``: "exact" (default), "fast", "fast_exact", "pallas"
    (per-frame ``mbcodec_frame`` kernel), "fused" / "fused_exact" (one
    ``mbcodec_chunk`` kernel per chunk).

    ``trace`` (``control.traces.NetworkTrace``) replaces the constant
    ``net`` model: transmit time integrates rate over the trace from the
    chunk's actual send time, and a chunk that finds the uplink still busy
    is charged ``queue_s`` (``core.pipeline.UplinkClock``; chunk ci is
    captured at ``ci * chunk_size / fps``).

    ``controller`` (``control.controller.RateController``) closes the
    loop: after every chunk the engine reports a ``ChunkObservation``
    (bytes, stream, queue and compute delay) and the controller sets its
    knobs for the next chunk. ``ControlledAccMPEGPolicy`` reads them as a
    tensor on the device, so a knob change costs no synchronisation."""

    def __init__(self, final_dnn, net: NetworkConfig = NetworkConfig(),
                 chunk_size: int = 10, impl: str = "exact",
                 trace=None, controller=None, fps: float = 30.0,
                 device="cuda"):
        CHUNK_ENCODERS.resolve(impl)  # fail on a bad name before a run
        self.final_dnn = final_dnn
        self.net = net
        self.chunk_size = chunk_size
        self.impl = impl
        self.trace = trace
        self.controller = controller
        self.fps = fps
        self.device = resolve_device(device)

    def chunks(self, frames):
        T = frames.shape[0]
        cs = self.chunk_size
        for ci, s in enumerate(range(0, T - T % cs, cs)):
            yield ci, torch.as_tensor(frames[s : s + cs], device=self.device)

    def camera_chunk(self, policy, ci: int, chunk) -> ChunkContext:
        """Camera side of one chunk (overhead + encode + transmit
        accounting)."""
        ctx = ChunkContext(self, ci, chunk)
        ctx.decoded = policy.encode_chunk(ctx)
        return ctx

    def run(self, policy, frames, refs: Optional[Sequence] = None,
            clock: Optional[UplinkClock] = None,
            start_chunk: int = 0) -> RunResult:
        """Stream ``frames`` through ``policy``; returns the paper's
        accounting. ``refs``: per-chunk D(H) outputs
        (``core.pipeline.make_reference``), on the absolute timeline.

        ``clock`` / ``start_chunk`` serve a segment of a longer timeline
        (trace mode): pass the previous segment's ``UplinkClock`` so that
        its backlog carries over, and ``start_chunk`` so that chunk ``ci``
        of this call is captured at ``(start_chunk + ci) * chunk_size /
        fps`` and scored against ``refs[start_chunk + ci]``."""
        policy.reset()
        if self.controller is not None:
            self.controller.reset()
        if clock is None and self.trace is not None:
            clock = UplinkClock(self.trace, self.chunk_size, self.fps)
        results = []
        for ci, chunk in self.chunks(frames):
            if ci == 0:
                # steady-state timing: build and launch every path the
                # policy uses before the first measured chunk
                policy.warm(self, chunk)
            ctx = self.camera_chunk(policy, ci, chunk)
            queue_s = 0.0
            if clock is None:
                stream_s = sum(stream_delay(b, self.net)
                               for b in ctx.transmissions)
            else:
                stream_s = 0.0
                ready = ctx.encode_s + ctx.overhead_s
                for b in ctx.transmissions:
                    s, q = clock.send(start_chunk + ci, b, ready)
                    stream_s += s
                    queue_s += q
                    # a later transmission of the same chunk (DDS's second
                    # pass) starts after this upload ends: advance its
                    # ready point so that the wait, already in stream_s,
                    # is not charged again as queue
                    ready += q + (s - clock.trace.rtt_s / 2.0)
            ref = refs[start_chunk + ci] if refs is not None else chunk
            acc = chunk_accuracy(self.final_dnn, ctx.decoded, ref)
            results.append(ChunkResult(acc, sum(ctx.transmissions),
                                       ctx.encode_s, ctx.overhead_s,
                                       stream_s, ctx.extra_rtt_s, queue_s,
                                       ci=start_chunk + ci))
            if self.controller is not None:
                from repro_torch.control.controller import ChunkObservation

                self.controller.observe(ChunkObservation(
                    n_bytes=sum(ctx.transmissions), stream_s=stream_s,
                    queue_s=queue_s,
                    compute_s=ctx.encode_s + ctx.overhead_s,
                    extra_rtt_s=ctx.extra_rtt_s))
        return RunResult(policy.name, results)
