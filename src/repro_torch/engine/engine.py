"""StreamingEngine: the single camera -> network -> server chunk loop
(port of ``repro.engine.engine``), in constant-network mode.

    per chunk:  encode delay (measured wall-clock)
              + camera-side model overhead (measured)
              + streaming delay (bytes * 8 / bandwidth + RTT/2 per
                transmission)
              + extra server RTTs (server-driven methods)

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
                                       chunk_accuracy, stream_delay)


def jit_encode(impl: str = "exact"):
    """The RoI chunk encoder ``impl`` from ``codec.CHUNK_ENCODERS``. PyTorch
    runs eagerly, so this is a registry lookup; the name is kept from the
    reference, whose version compiled the encoder."""
    return CHUNK_ENCODERS.resolve(impl)


class ChunkContext:
    """Per-chunk execution context handed to ``QPPolicy.encode_chunk``:
    owns timing and byte accounting. Camera-side model work goes through
    :meth:`time_overhead`, every encode through :meth:`encode` /
    :meth:`encode_uniform` (each is one transmission)."""

    def __init__(self, engine: "StreamingEngine", ci: int,
                 chunk: torch.Tensor):
        self.engine = engine
        self.ci = ci
        self.chunk = chunk
        self.encode_s = 0.0
        self.overhead_s = 0.0
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

    def encode(self, qp_maps: torch.Tensor) -> torch.Tensor:
        """RoI-encode the chunk with per-macroblock QP maps (T or 1
        leading) through the engine's ``impl`` backend."""
        return self._timed_encode(jit_encode(self.engine.impl), self.chunk,
                                  qp_maps)

    def encode_uniform(self, qp: int) -> torch.Tensor:
        return self._timed_encode(encode_chunk_uniform, self.chunk, qp)


class StreamingEngine:
    """Runs any QPPolicy through the shared chunk loop on ``device``.

    ``impl`` names the ``codec.CHUNK_ENCODERS`` backend for every
    ``ctx.encode``: "exact" (default), "fast", "fast_exact", "pallas"
    (per-frame ``mbcodec_frame`` kernel), "fused" / "fused_exact" (one
    ``mbcodec_chunk`` kernel per chunk). The reference's ``trace`` and
    ``controller`` modes arrive with a later slice; here they must be
    None."""

    def __init__(self, final_dnn, net: NetworkConfig = NetworkConfig(),
                 chunk_size: int = 10, impl: str = "exact",
                 trace=None, controller=None, device="cuda"):
        if trace is not None or controller is not None:
            raise NotImplementedError(
                "trace / controller modes are not ported yet")
        CHUNK_ENCODERS.resolve(impl)  # fail on a bad name before a run
        self.final_dnn = final_dnn
        self.net = net
        self.chunk_size = chunk_size
        self.impl = impl
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

    def run(self, policy, frames,
            refs: Optional[Sequence] = None) -> RunResult:
        """Stream ``frames`` through ``policy``; returns the paper's
        accounting. ``refs``: per-chunk D(H) outputs
        (``core.pipeline.make_reference``)."""
        policy.reset()
        results = []
        for ci, chunk in self.chunks(frames):
            if ci == 0:
                # steady-state timing: build and launch every path the
                # policy uses before the first measured chunk
                policy.warm(self, chunk)
            ctx = self.camera_chunk(policy, ci, chunk)
            stream_s = sum(stream_delay(b, self.net)
                           for b in ctx.transmissions)
            ref = refs[ci] if refs is not None else chunk
            acc = chunk_accuracy(self.final_dnn, ctx.decoded, ref)
            results.append(ChunkResult(acc, sum(ctx.transmissions),
                                       ctx.encode_s, ctx.overhead_s,
                                       stream_s, ci=ci))
        return RunResult(policy.name, results)
