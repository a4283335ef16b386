"""Pipelined multi-stream serving (port of ``repro.engine.multistream``):
one camera step per chunk interval serves N camera streams that share one
uplink, the server DNN is batched across the streams, and the stages
overlap.

Per chunk interval the loop runs three stages: the fleet camera step
(``serve.steps.make_camera_fleet_step``, device), the batched server DNN
(``serve.steps.make_server_fleet_step``, device) and host-side accuracy
scoring plus processor-sharing uplink delays
(``core.pipeline.shared_stream_delays``). With ``overlap=True`` the host
scores chunk ci - depth while the device still works on later chunks.

What stands in for JAX's asynchronous dispatch: the steps enqueue their
kernels on the current CUDA stream and return. A plain ``.cpu()`` of the
server outputs would wait behind the camera step enqueued after them and
the overlap would vanish without an error, so the outputs and byte
matrices are copied to pinned host memory with ``non_blocking=True`` as
they are enqueued, a CUDA event is recorded after the copies, and
:meth:`MultiStreamEngine._finish` waits on that event only. The camera
step's end is an event too (the counterpart of
``jax.block_until_ready(decoded)``), not ``torch.cuda.synchronize()``.
Host frames are pinned once per run, and each chunk is copied to the card
stream by stream without waiting: a copy from pageable memory would wait
for the device queue to drain. On the CPU every step runs synchronously.

Accounting follows the reference: per-stream ``encode_s`` is the fleet
camera step's time (under overlap, one hot step timed after warm-up);
server inference stays out of per-stream delay and is tracked in
``FleetResult.timing`` for serving-tier capacity only.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.pipeline import (ChunkResult, FleetTiming, NetworkConfig,
                                       RunResult, shared_stream_delays)
from repro_torch.engine.config import EngineConfig
from repro_torch.engine.engine import synchronize
from repro_torch.serve.steps import (make_camera_fleet_step,
                                     make_server_fleet_step)
from repro_torch.vision.dnn import detection_keep_heat


@dataclasses.dataclass
class FleetResult:
    """Per-stream results plus fleet-level camera timing. (The reference's
    ``serve_loop``, multi-host, windowed and tenant fields come with their
    slices.)"""

    streams: List[RunResult]
    camera_s: List[float]     # fleet camera-step time per chunk
    timing: Optional[FleetTiming] = None  # full pipeline accounting
    served_cis: Optional[List[int]] = None  # chunk interval of each
    # ``camera_s`` entry

    @property
    def n_streams(self):
        return len(self.streams)

    @property
    def accuracy(self):
        return float(np.mean([r.accuracy for r in self.streams]))

    @property
    def mean_camera_s(self):
        return float(np.mean(self.camera_s))

    @property
    def chunks_per_s(self):
        """Fleet camera throughput: stream-chunks processed per second."""
        return self.n_streams / max(self.mean_camera_s, 1e-12)

    def _delay_percentile(self, q: float) -> float:
        delays = [c.total_delay_s for r in self.streams for c in r.chunks]
        return float(np.percentile(delays, q)) if delays else float("nan")

    @property
    def p90_delay(self):
        """Tail end-to-end chunk delay pooled over every stream-chunk."""
        return self._delay_percentile(90)

    def summary(self):
        s = {
            "n_streams": self.n_streams,
            "accuracy": self.accuracy,
            "camera_s_per_chunk": self.mean_camera_s,
            "chunks_per_s": self.chunks_per_s,
            "p95_delay_s": self._delay_percentile(95),
        }
        if self.timing is not None:
            s.update(wall_s=self.timing.wall_s,
                     serialized_s=self.timing.serialized_s,
                     overlap_speedup=self.timing.overlap_speedup)
        return s


def _record(device: torch.device):
    """A CUDA event recorded on the current stream (None on the CPU, where
    every step has already finished)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record()
    return event


def _wait(event):
    if event is not None:
        event.synchronize()


def _to_host(tree: dict) -> dict:
    """Start copying a dict of tensors to the host. From the card the copy
    goes to pinned memory without waiting (``non_blocking``); read the
    results only after an event recorded behind it has completed."""
    return {k: v.to("cpu", non_blocking=True) for k, v in tree.items()}


def _chunk_source(frames, device: torch.device):
    """``put(s, e)``: the fleet's frames ``[:, s:e]`` on ``device``."""
    if isinstance(frames, torch.Tensor):
        if frames.device == device:
            return lambda s, e: frames[:, s:e]
        frames = frames.cpu().numpy()
    host = np.asarray(frames, np.float32)
    if device.type != "cuda":
        return lambda s, e: torch.from_numpy(np.ascontiguousarray(
            host[:, s:e]))
    # pinned once per run; each stream's slice of it is contiguous
    pinned = torch.from_numpy(np.ascontiguousarray(host)).pin_memory()
    pinned_np = pinned.numpy()

    def put(s, e):
        out = torch.empty((host.shape[0], e - s) + host.shape[2:],
                          dtype=torch.float32, device=device)
        for i in range(host.shape[0]):
            out[i].copy_(torch.from_numpy(pinned_np[i, s:e]),
                         non_blocking=True)
        return out

    put.keep_alive = pinned  # the copies read it until they complete
    return put


class MultiStreamEngine:
    """Batched AccMPEG serving for N cameras sharing one uplink, on one
    device (``device``, default ``"cuda"``; ``"cpu"`` runs the plain
    PyTorch paths).

    ``config`` (:class:`~repro_torch.engine.config.EngineConfig`): ``impl``
    names the chunk-encoder backend ("fused" / "fused_exact" take the
    stream-batched scores kernel); ``overlap`` pipelines the server DNN
    and host scoring against later chunks' camera steps (False = the
    serialized camera -> server -> host loop); ``depth`` chunks stay in
    flight when overlapped; ``detail`` "chunks" scores all lanes in one
    vectorized pass, "legacy" lane by lane (bit-identical);
    ``sim_encode_s`` replaces the accounted camera time with a constant.
    """

    def __init__(self, final_dnn, accmodel, *,
                 config: Optional[EngineConfig] = None, device="cuda"):
        config = config or EngineConfig()
        self.config = config
        self.final_dnn = final_dnn
        self.accmodel = accmodel
        self.device = resolve_device(device)
        self.qcfg = config.qcfg
        self.net = config.net
        self.chunk_size = config.chunk_size
        self.impl = config.impl
        self.overlap = config.overlap
        self.depth = config.depth
        self.sim_encode_s = config.sim_encode_s
        self.detail = config.detail
        self._camera = make_camera_fleet_step(accmodel, config.qcfg,
                                              impl=config.impl)
        self._server = make_server_fleet_step(final_dnn)
        self._warm = {}     # (shape, refs is None, overlap) -> steady times
        self._refs_prepared = None  # (refs object, prepared copy)

    # -- steady-state timing ----------------------------------------------------
    def _steady_times(self, camera, server_step, warm, refs_none: bool,
                      overlap: bool, key):
        """Run the camera and server steps once outside the timed loop (the
        first launch also builds the kernels), then, under overlap, time
        one hot step of each: the steady-state estimates that per-stream
        ``encode_s`` and ``timing.server_s`` report while the pipelined
        loop's spans absorb overlapped work. Cached per key."""
        if key in self._warm:
            return self._warm[key]
        d0 = camera(warm)[0]
        server_step(d0)
        synchronize(self.device)
        cam_steady_s = server_steady_s = 0.0
        if overlap:  # serialized mode measures stages per chunk instead
            t0 = time.perf_counter()
            camera(warm)
            synchronize(self.device)
            cam_steady_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            server_step(d0)
            if refs_none:  # refs=None: second server pass per chunk
                server_step(warm)
            synchronize(self.device)
            server_steady_s = time.perf_counter() - t0
        self._warm[key] = (cam_steady_s, server_steady_s)
        return self._warm[key]

    def _prepare_refs(self, refs):
        """References as host numpy trees, prepared once up front: raw
        high-quality frames become server-DNN outputs, and detection refs
        get their NMS (``"keep"``), so the per-chunk host stage touches
        numpy only. Cached by the identity of ``refs``, which are treated
        as immutable once passed."""
        if refs is None:
            return None
        if self._refs_prepared is not None and self._refs_prepared[0] is refs:
            return self._refs_prepared[1]
        detection = self.final_dnn.task == "detection"
        prepared = []
        for stream_refs in refs:
            row = []
            for r in stream_refs:
                if not isinstance(r, dict):  # raw frames -> D(ref)
                    r = self.final_dnn.predict(r)
                r = {k: torch.as_tensor(v) for k, v in r.items()}
                if detection and "keep" not in r:
                    r["keep"] = detection_keep_heat(r)
                row.append({k: v.detach().cpu().numpy()
                            for k, v in r.items()})
            prepared.append(row)
        self._refs_prepared = (refs, prepared)
        return prepared

    # -- chunk post-processing (host side) ------------------------------------
    def _finish(self, p, per_stream, net, refs, timing, overlap: bool):
        """Host scoring and uplink accounting for one chunk. It waits only
        for this chunk's copies to the host; under overlap the device
        meanwhile runs the later chunks' steps."""
        _wait(p["ready"])
        outs = {k: v.numpy() for k, v in p["outs"].items()}
        ref_outs = None if p["ref_outs"] is None else {
            k: v.numpy() for k, v in p["ref_outs"].items()}
        if overlap:
            timing.server_s.append(p["server_steady_s"])
        t0 = time.perf_counter()
        ci = p["ci"]
        pbytes = p["pbytes"].numpy()
        n_lanes = pbytes.shape[0]
        # .tolist() feeds the delay solver the same Python floats as the
        # reference
        lane_bytes = pbytes.reshape(n_lanes, -1).sum(axis=1).tolist()
        delays = shared_stream_delays(lane_bytes, net)
        if self.detail == "legacy":
            accs = []
            for i in range(n_lanes):
                out_i = {k: v[i] for k, v in outs.items()}
                ref = refs[i][ci] if refs is not None else {
                    k: v[i] for k, v in ref_outs.items()}
                accs.append(self.final_dnn.accuracy(out_i, ref))
        else:
            if refs is not None:
                ref_a = {k: np.stack([refs[i][ci][k] for i in range(n_lanes)])
                         for k in refs[0][ci]}
            else:
                ref_a = ref_outs
            accs = self.final_dnn.accuracy_batched(outs, ref_a)
        for i in range(n_lanes):
            per_stream[i].append(ChunkResult(
                float(accs[i]), lane_bytes[i], encode_s=p["cam_dt"],
                overhead_s=0.0, stream_s=delays[i], queue_s=0.0, ci=ci))
        timing.host_s.append(time.perf_counter() - t0)

    # -- the pipelined fleet loop ---------------------------------------------
    def run(self, frames, refs: Optional[Sequence[Sequence]] = None,
            net: Optional[NetworkConfig] = None) -> FleetResult:
        """frames (N, T, H, W, C), numpy or a tensor; refs[i][ci]:
        per-stream per-chunk D(H) references (optional; without them the
        reference outputs are the server DNN on the raw chunk, batched like
        everything else)."""
        N, T = frames.shape[:2]
        cs = self.chunk_size
        net = net or self.net or NetworkConfig.shared(2.5e6, N)
        cam_step, server_step = self._camera, self._server
        per_stream: List[List[ChunkResult]] = [[] for _ in range(N)]
        timing = FleetTiming()
        starts = list(range(0, T - T % cs, cs))
        refs = self._prepare_refs(refs)
        put = _chunk_source(frames, self.device)
        dev = self.device

        warm_key = (tuple(frames.shape), refs is None, self.overlap)
        cam_steady_s, server_steady_s = self._steady_times(
            cam_step, server_step, put(0, cs), refs is None, self.overlap,
            warm_key)

        # ``depth`` chunks stay in flight: at iteration ci the host scores
        # chunk ci - depth, whose outputs are long since on the host, while
        # the device queue holds the later chunks' server and camera steps
        pending: List[dict] = []
        depth = self.depth
        t_run = time.perf_counter()
        for ci, s in enumerate(starts):
            batch = put(s, s + cs)
            t0 = time.perf_counter()
            decoded, pbytes, _ = cam_step(batch)    # enqueued
            cam_ready = _record(dev)
            if self.overlap and len(pending) >= depth:
                self._finish(pending.pop(0), per_stream, net, refs, timing,
                             True)
            _wait(cam_ready)
            cam_dt = cam_steady_s if self.overlap \
                else time.perf_counter() - t0
            timing.camera_s.append(cam_dt)
            # accounting charge: the measured step time, or the fixed
            # simulation constant
            acct_dt = cam_dt if self.sim_encode_s is None \
                else self.sim_encode_s
            t1 = time.perf_counter()
            outs = server_step(decoded)           # batched server DNN
            ref_outs = server_step(batch) if refs is None else None
            entry = dict(ci=ci, outs=_to_host(outs),
                         ref_outs=None if ref_outs is None
                         else _to_host(ref_outs),
                         pbytes=pbytes.to("cpu", non_blocking=True),
                         cam_dt=acct_dt, server_steady_s=server_steady_s)
            entry["ready"] = _record(dev)
            pending.append(entry)
            if not self.overlap:
                _wait(entry["ready"])
                timing.server_s.append(time.perf_counter() - t1)
                self._finish(pending.pop(0), per_stream, net, refs, timing,
                             False)
        while pending:
            self._finish(pending.pop(0), per_stream, net, refs, timing,
                         self.overlap)
        timing.wall_s = time.perf_counter() - t_run
        streams = [RunResult(f"accmpeg_fleet[{i}]", per_stream[i])
                   for i in range(N)]
        return FleetResult(streams, timing.camera_s, timing=timing,
                           served_cis=list(range(len(starts))))
