"""The fleet's per-chunk steps (port of ``repro.serve.steps``): the whole
camera side of N AccMPEG streams, the server DNN batched across them, and
the per-lane accuracy reduce of windowed serving.

The reference lowers each step into one jitted XLA program with the
stream axis leading. PyTorch runs eagerly, so here each step is a plain
function over ``(N, T, H, W, C)`` chunk batches that enqueues its work on
the current CUDA stream and returns without waiting: the fleet engine
decides when the host waits. The ``fused`` backends' camera step is one
AccModel call, one dilation and one ``mbcodec_chunk_scores`` kernel
launch for the whole fleet. Only the single-device form exists (``mesh``
must be None); the stream mesh comes with the multi-GPU slice.

The tenant-routed steps (``make_tenant_*``, from the reference's
multi-tenant plane) serve a fleet whose lanes belong to several tenants,
each with its own AccModel and server DNN. The reference gathers each
lane's parameters out of a stacked tree inside one program. Here lanes
are grouped by tenant instead: the engine knows each lane's tenant on the
host before it dispatches, copies each tenant's lane indices to the card
(:class:`TenantLanes`), and each tenant's model runs once, densely, over
its own lanes. That is one launch per tenant and layer, not one per lane,
and every convolution keeps its ordinary dense form (a ``vmap`` over
stacked weights would turn each into a grouped convolution).

The LM's steps (``make_prefill_step``, ``make_decode_step``,
``greedy_generate``) wrap ``models.DecoderLM`` the same way: eager calls
on the model's device, the parameters held by the model.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.codec.codec import CHUNK_ENCODERS, encode_chunk_batched
from repro_torch.core.quality import (dilate_scores,
                                      qp_maps_from_knobs_batched,
                                      qp_maps_from_scores_batched)
from repro_torch.kernels.mbcodec.ops import encode_chunk_fused_scores_batched
from repro_torch.serve.tenants import TASK_KEYS, validate_tenants
from repro_torch.vision.dnn import (STRIDE, TASK_HEADS, detection_keep_heat,
                                    device_lane_accuracy)


def _no_mesh(mesh, step: str):
    if mesh is not None:
        raise NotImplementedError(
            f"{step}: stream meshes over several GPUs come with the "
            f"multi-GPU slice (ROADMAP module 8); pass mesh=None")


def make_camera_fleet_step(accmodel, qcfg, impl: str = "fast", mesh=None,
                           knobs: bool = False, mask: bool = False):
    """Build the per-chunk camera step for N streams.

    Returns ``step(chunks)`` with ``chunks (N, T, H, W, C)`` on the
    AccModel's device -> ``(decoded (N, T, H, W, C), bytes (N, T), scores
    (N, mb_h, mb_w))``.

    Frame sampling is the paper's k = chunk size: the AccModel scores each
    stream's chunk head, and the stream's QP map holds for the whole
    chunk. ``impl`` names the ``codec.CHUNK_ENCODERS`` backend. "fused" /
    "fused_exact" take the scores path: the dilated score map and the
    (alpha, qp_hi, qp_lo) knob triple go to one stream-batched
    ``mbcodec_chunk_scores`` launch, which assigns the two-level QP inside
    the kernel, so no QP map exists in device memory. Every other impl
    builds the QP maps (``qp_maps_from_*_batched``) and codes each stream
    with ``encode_chunk_batched``.

    ``knobs=True`` builds ``step(chunks, knob_array)``: alpha, qp_hi,
    qp_lo and drop_thresh arrive as a tensor on the device (the fleet
    engine's ``RateController``'s) instead of ``qcfg``'s constants, and
    frames whose change feature falls below drop_thresh are replaced by
    the previous kept frame (``soft_drop_previous``); ``qcfg.gamma`` stays
    fixed. ``mask=True`` builds ``step(chunks, active[, knob_array])``
    with an ``(N,)`` lane mask: padded lanes run like the others, but
    their bytes are zeroed on the device."""
    # imported here: the engine package imports this module
    from repro_torch.engine.policies import soft_drop_previous

    _no_mesh(mesh, "make_camera_fleet_step")
    CHUNK_ENCODERS.resolve(impl)  # fail on a bad name before a run
    fused_scores = impl in ("fused", "fused_exact")
    clip_refs = impl == "fused_exact"
    # the baked knob triple, copied to the card once here: a host copy per
    # chunk would wait for the device and undo the engine's overlap
    baked = torch.tensor([qcfg.alpha, float(qcfg.qp_hi), float(qcfg.qp_lo)],
                         dtype=torch.float32, device=accmodel.device)

    def step(chunks, *args):
        active = args[0] if mask else None
        knob_arr = args[-1] if knobs else None
        scores = accmodel.scores(chunks[:, 0])
        if knob_arr is not None:
            chunks = torch.stack([soft_drop_previous(c, knob_arr[3])[0]
                                  for c in chunks])
        if fused_scores:
            pooled = dilate_scores(scores, qcfg.gamma)
            triple = baked if knob_arr is None else knob_arr[:3]
            decoded, pbytes = encode_chunk_fused_scores_batched(
                chunks, pooled, triple, clip_refs)
        else:
            if knob_arr is None:
                qmaps, _ = qp_maps_from_scores_batched(scores, qcfg)
            else:
                qmaps, _ = qp_maps_from_knobs_batched(scores, knob_arr,
                                                      qcfg.gamma)
            decoded, pbytes = encode_chunk_batched(chunks, qmaps, impl)
        if active is not None:  # zero padded lanes' wire bytes on the card
            pbytes = pbytes * active.to(pbytes.dtype).reshape(
                (-1,) + (1,) * (pbytes.dim() - 1))
        return decoded, pbytes, scores

    return step


def make_server_fleet_step(final_dnn, mesh=None):
    """Batch the server DNN across streams.

    Returns ``server(decoded (N, T, H, W, C)) -> dict of (N, T, ...)``
    outputs: one ``FinalDNN`` forward over the flattened N*T frames. For
    detection the NMS half of decoding (``detection_keep_heat``) runs in
    the same step, as ``"keep"``, so the host stage is numpy only."""
    _no_mesh(mesh, "make_server_fleet_step")
    detection = final_dnn.task == "detection"

    @torch.no_grad()
    def server(decoded):
        N, T = decoded.shape[:2]
        out = final_dnn(decoded.reshape((N * T,) + tuple(decoded.shape[2:])))
        if detection:
            out["keep"] = detection_keep_heat(out)
        return {k: v.reshape((N, T) + tuple(v.shape[1:]))
                for k, v in out.items()}

    return server


def make_accuracy_reduce_step(final_dnn, mesh=None):
    """Device-side per-lane accuracy reduction for windowed aggregation.

    Returns ``acc(outs, ref_outs) -> (N,)`` float32, where both arguments
    are the (N, T, ...) output dicts of :func:`make_server_fleet_step`.
    With this step in the pipeline only N accuracy scalars (plus the
    (N, T) byte matrix) cross to the host per chunk; the dense output
    trees stay on the device. Plain PyTorch, as the reference computes it
    in jnp outside any Pallas kernel. Only for tasks
    :func:`~repro_torch.vision.dnn.device_lane_accuracy` supports
    (segmentation, keypoint); the engine scores detection on the host."""
    _no_mesh(mesh, "make_accuracy_reduce_step")
    task = final_dnn.task

    @torch.no_grad()
    def acc(outs, ref_outs):
        return device_lane_accuracy(task, outs, ref_outs)

    return acc


# ---------------------------------------------------------------------------
# tenant-routed fleet steps (multi-tenant serving: one fleet, many DNNs)
# ---------------------------------------------------------------------------
def to_device_async(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """``host`` as a tensor on ``device``; to the card it is copied from
    pinned memory without waiting for the device."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class TenantLanes:
    """The (N,) tenant-id lane of one fleet batch, in the form the tenant
    steps use. ``host``: the ids as the engine built them (padded lanes
    route to tenant 0); ``ids``: the same on ``device``; ``lanes[t]``:
    tenant t's lane indices on ``device`` (None when it has no lane) and
    ``counts[t]`` their number. The device copies are started without a
    wait, as the lane mask's are, so building this never synchronises."""

    def __init__(self, ids, n_tenants: int, device):
        host = np.asarray(ids, np.int64).reshape(-1)
        if host.size and (host.min() < 0 or host.max() >= n_tenants):
            raise ValueError(f"tenant ids {host.tolist()} outside the "
                             f"fleet's {n_tenants} tenants")
        device = torch.device(device)
        self.host = host
        self.counts = np.bincount(host, minlength=n_tenants)
        self.ids = to_device_async(host, device)
        self.lanes = [to_device_async(np.flatnonzero(host == t), device)
                      if self.counts[t] else None for t in range(n_tenants)]


def as_tenant_lanes(tenant_ids, n_tenants: int, device) -> TenantLanes:
    """``tenant_ids`` as :class:`TenantLanes`: one already, or host ids
    (numpy, a list, a CPU tensor). Ids on the card are refused: grouping
    lanes by tenant from them would wait for the device."""
    if isinstance(tenant_ids, TenantLanes):
        return tenant_ids
    if isinstance(tenant_ids, torch.Tensor):
        if tenant_ids.device.type != "cpu":
            raise ValueError(
                "the tenant steps group lanes by tenant on the host: pass "
                "the tenant ids as host data (numpy, a list, a CPU tensor) "
                "or as TenantLanes, not as a tensor on the card")
        tenant_ids = tenant_ids.numpy()
    return TenantLanes(tenant_ids, n_tenants, device)


def make_tenant_camera_fleet_step(tenants, impl: str = "fast", mesh=None,
                                  mask: bool = False):
    """Tenant-routed camera step: ``step(chunks, tenant_ids[, active])``.

    The contract of :func:`make_camera_fleet_step` plus an (N,) tenant-id
    lane (:func:`as_tenant_lanes`): each tenant's AccModel scores the
    chunk heads of its own lanes in one call, and each lane gets its own
    tenant's ``QualityConfig``. Under ``fused`` / ``fused_exact`` every
    tenant shares one config (``validate_tenants``), so the fleet takes
    one ``mbcodec_chunk_scores`` launch with that knob triple; otherwise
    every tenant's QP map is built over all lanes (macroblock resolution,
    cheap next to the encode) and each lane takes its own tenant's before
    ``encode_chunk_batched`` (under ``pallas``, the frame kernel). With
    ``mask=True`` padded lanes' bytes are zeroed on the device."""
    _no_mesh(mesh, "make_tenant_camera_fleet_step")
    tenants = validate_tenants(tenants, impl)
    CHUNK_ENCODERS.resolve(impl)
    fused_scores = impl in ("fused", "fused_exact")
    clip_refs = impl == "fused_exact"
    q0 = tenants[0].qcfg  # the shared config of the fused backends
    baked = torch.tensor([q0.alpha, float(q0.qp_hi), float(q0.qp_lo)],
                         dtype=torch.float32,
                         device=tenants[0].accmodel.device)

    def step(chunks, tenant_ids, active=None):
        N = chunks.shape[0]
        lanes = as_tenant_lanes(tenant_ids, len(tenants), chunks.device)
        heads = chunks[:, 0]
        scores = None
        for spec, idx in zip(tenants, lanes.lanes):
            if idx is None:
                continue
            s = spec.accmodel.scores(heads.index_select(0, idx))
            if scores is None:
                scores = s.new_empty((N,) + tuple(s.shape[1:]))
            scores.index_copy_(0, idx, s)
        if fused_scores:
            decoded, pbytes = encode_chunk_fused_scores_batched(
                chunks, dilate_scores(scores, q0.gamma), baked, clip_refs)
        else:
            per_t = torch.stack([qp_maps_from_scores_batched(
                scores, spec.qcfg)[0] for spec in tenants])
            qmaps = per_t[lanes.ids, torch.arange(N, device=chunks.device)]
            decoded, pbytes = encode_chunk_batched(chunks, qmaps, impl)
        if active is not None:  # zero padded lanes' wire bytes on the card
            pbytes = pbytes * active.to(pbytes.dtype).reshape(
                (-1,) + (1,) * (pbytes.dim() - 1))
        return decoded, pbytes, scores

    return step


def make_tenant_server_fleet_step(tenants, mesh=None):
    """Tenant-grouped server step: ``server(decoded, tenant_ids)`` -> the
    union dict of ``(N, T, ...)`` outputs of every tenant's task.

    Each tenant's ``FinalDNN`` runs once over its own lanes' n_t x T
    frames as one dense batch, so each lane's backbone runs exactly once,
    with its tenant's weights; detection tenants' ``keep`` (the NMS half
    of decoding) comes in the same step. Results are written into the
    union tensors at their lanes; a lane's entries under another task's
    keys stay zero, and nothing reads them (host scoring and the accuracy
    reduce read each lane's own task). Tenants need not share a width."""
    _no_mesh(mesh, "make_tenant_server_fleet_step")
    tenants = validate_tenants(tenants)
    channels = {}  # union key -> channels of its last axis (None: keep)
    for spec in tenants:
        for k in TASK_KEYS[spec.task]:
            channels[k] = TASK_HEADS[spec.task].get(k)

    @torch.no_grad()
    def server(decoded, tenant_ids):
        N, T, H, W = decoded.shape[:4]
        lanes = as_tenant_lanes(tenant_ids, len(tenants), decoded.device)
        hs, ws = -(-H // STRIDE), -(-W // STRIDE)
        out = {k: decoded.new_zeros((N, T, hs, ws) + ((c,) if c else ()))
               for k, c in channels.items()}
        for spec, idx, n in zip(tenants, lanes.lanes, lanes.counts):
            if idx is None:
                continue
            frames = decoded.index_select(0, idx)
            res = spec.dnn(frames.reshape((int(n) * T,)
                                          + tuple(decoded.shape[2:])))
            if spec.task == "detection":
                res["keep"] = detection_keep_heat(res)
            for k, v in res.items():
                out[k].index_copy_(0, idx, v.reshape(
                    (int(n), T) + tuple(v.shape[1:])))
        return out

    return server


def make_tenant_accuracy_reduce_step(tenants, mesh=None):
    """Tenant-routed device accuracy reduce: ``acc(outs, ref_outs,
    tenant_ids) -> (N,)`` over the tenant server step's union outputs.
    Each distinct task's ``device_lane_accuracy`` runs over all lanes and
    each lane takes its own tenant's task's value. Only for fleets whose
    every tenant's task reduces on the device (the engine scores on the
    host otherwise)."""
    _no_mesh(mesh, "make_tenant_accuracy_reduce_step")
    tenants = validate_tenants(tenants)
    tasks = list(dict.fromkeys(spec.task for spec in tenants))
    task_of = torch.tensor([tasks.index(spec.task) for spec in tenants],
                           device=tenants[0].dnn.device)

    @torch.no_grad()
    def acc(outs, ref_outs, tenant_ids):
        vals = [device_lane_accuracy(task, outs, ref_outs)
                for task in tasks]
        if len(vals) == 1:
            return vals[0]
        lane_task = task_of[as_tenant_lanes(
            tenant_ids, len(tenants), task_of.device).ids]
        out = vals[0]
        for k in range(1, len(vals)):
            out = torch.where(lane_task == k, vals[k], out)
        return out

    return acc


# ---------------------------------------------------------------------------
# LM serving: prefill, one greedy decode step, and the greedy loop
# ---------------------------------------------------------------------------


def make_prefill_step(model, cfg, max_seq=None):
    """``step(batch) -> (cache, last_logits)`` for ``batch["tokens"]`` (B,
    S) and, for a VLM, ``batch["context"]`` (B, n_frontend_tokens, d), the
    image tokens its XATTN layers attend, or, for an encoder-decoder,
    ``batch["frames"]`` (B, enc_len, d), its encoder's input. The
    reference's step prefills without ``max_seq``, which leaves no room in
    the K/V cache (its writes then clamp onto the last token); a decoder
    that follows passes the length to serve up to."""
    def prefill(batch):
        extras = {k: batch[k] for k in ("context", "frames") if k in batch}
        return model.prefill(batch["tokens"], extras, max_seq=max_seq)

    return prefill


def make_decode_step(model, cfg):
    """``step(cache, token (B, 1), pos) -> (cache, next_token (B,) int32,
    logits (B, 1, V))``: one greedy step."""
    def decode(cache, token, pos):
        cache, logits = model.decode(cache, token, pos)
        next_token = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return cache, next_token, logits

    return decode


def greedy_generate(model, prompt, steps: int, cache=None):
    """The reference's autoregressive loop (examples and equivalence
    tests): the prompt goes in token by token through ``decode``, then
    ``steps`` greedy tokens come out (B, steps)."""
    B, S = prompt.shape
    if cache is None:
        cache = model.init_cache(B, S + steps)
    tok = prompt[:, :1]
    outs = []
    for t in range(S + steps - 1):
        cache, logits = model.decode(cache, tok, t)
        nxt = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(prompt.dtype)
        if t + 1 < S:
            tok = prompt[:, t + 1:t + 2]
        else:
            tok = nxt
            outs.append(nxt)
    return torch.cat(outs, dim=1) if outs else prompt[:, :0]
