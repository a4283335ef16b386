"""The fleet's per-chunk steps (port of ``repro.serve.steps``): the whole
camera side of N AccMPEG streams, and the server DNN batched across them.

The reference lowers each step into one jitted XLA program with the
stream axis leading. PyTorch runs eagerly, so here each step is a plain
function over ``(N, T, H, W, C)`` chunk batches that enqueues its work on
the current CUDA stream and returns without waiting: the fleet engine
decides when the host waits. The ``fused`` backends' camera step is one
AccModel call, one dilation and one ``mbcodec_chunk_scores`` kernel
launch for the whole fleet. Only the single-device form exists (``mesh``
must be None); the stream mesh comes with the multi-GPU slice.

The LM's steps (``make_prefill_step``, ``make_decode_step``,
``greedy_generate``) wrap ``models.DecoderLM`` the same way: eager calls
on the model's device, the parameters held by the model.
"""
from __future__ import annotations

import torch

from repro_torch.codec.codec import CHUNK_ENCODERS, encode_chunk_batched
from repro_torch.core.quality import (dilate_scores,
                                      qp_maps_from_knobs_batched,
                                      qp_maps_from_scores_batched)
from repro_torch.kernels.mbcodec.ops import encode_chunk_fused_scores_batched
from repro_torch.vision.dnn import detection_keep_heat


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
    qp_lo and drop_thresh arrive as a tensor on the device (the rate
    controller's, in a later slice) instead of ``qcfg``'s constants, and
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


# ---------------------------------------------------------------------------
# LM serving: prefill, one greedy decode step, and the greedy loop
# ---------------------------------------------------------------------------


def make_prefill_step(model, cfg, max_seq=None):
    """``step(batch) -> (cache, last_logits)`` for ``batch["tokens"]`` (B,
    S). The reference's step prefills without ``max_seq``, which leaves no
    room in the K/V cache (its writes then clamp onto the last token); a
    decoder that follows passes the length to serve up to."""
    def prefill(batch):
        if "context" in batch or "frames" in batch:
            raise NotImplementedError("cross-attention and enc-dec inputs "
                                      "are not ported (ROADMAP, module 9)")
        return model.prefill(batch["tokens"], max_seq=max_seq)

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
