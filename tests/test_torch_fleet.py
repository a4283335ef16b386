"""The fleet serving path of the port against the reference on the CPU:
uplink accounting, batched QP maps, frame drop, batched accuracy, the
fleet camera and server steps, the engine config, and the slice as a
whole (``MultiStreamEngine.run``), with the reference's weights carried
across.

Tolerances, each with its reason:
- host accounting (``NetworkConfig.shared``, ``shared_stream_delays``,
  ``pipeline_makespan``, ``FleetTiming``) and batched accuracy on shared
  numpy inputs: bit-equal, both are the same float64 numpy;
- QP maps and frame drop: equal, being thresholds of scores that lie far
  from alpha (AccModel scores within 1e-5);
- decoded frames atol 1e-5 and bytes rtol 1e-3 (``tests/test_kernels.py``'s
  bounds); server outputs atol 1e-4 (float order of two conv libraries);
- the slice: per stream and chunk, accuracy within 1e-6 and bytes within
  rtol 1e-3; timing fields excluded.

The engine runs use the weights of ``tests/test_torch_engine.py`` (heads
scaled so that detections are sparse and well separated) and its seed
rule: the streams' scenes, seeds 41, 43 and 44, each have every AccModel
score, NMS comparison, detection score and IoU at least 1e-5 from its
threshold, and no codec round-half flip between the two packages' exact
encoders (checked by ``test_fleet_seeds_are_well_posed``). Seeds 38, 45
and 46 miss that margin.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.codec import codec as jc
from repro.core import accmodel as jam
from repro.core import pipeline as jp
from repro.core import quality as jq
from repro.data.video import make_scene
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import MultiStreamEngine as JMultiStreamEngine
from repro.engine import policies as jpol
from repro.kernels.mbcodec import ops as jops
from repro.serve import steps as jsteps
from repro.vision import dnn as jv
from repro_torch.codec import codec as tc
from repro_torch.core import pipeline as tp
from repro_torch.core import quality as tq
from repro_torch.core.pipeline import make_reference
from repro_torch.engine import (AccMPEGPolicy, EngineConfig, FleetResult,
                                MultiStreamEngine, StreamingEngine)
from repro_torch.engine import policies as tpol
from repro_torch.kernels.mbcodec import ops as tops
from repro_torch.serve import steps as tsteps
from repro_torch.vision import dnn as tv
from repro_torch.weights import accmodel_from_numpy, final_dnn_from_numpy

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - exercised when hypothesis is absent
    from _hypothesis_compat import given, settings, st

H, W, T, WIDTH = 96, 160, 20, 8
SEEDS = (41, 43, 44)
ALPHA, GAMMA, QP_LO = 0.7, 1, 46
QCFG = dict(alpha=ALPHA, gamma=GAMMA, qp_lo=QP_LO)
ACC_ATOL, BYTES_RTOL, DEC_ATOL, MARGIN = 1e-6, 1e-3, 1e-5, 1e-5


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def weights():
    det = _np_tree(jv.init_net("detection", jax.random.PRNGKey(2), WIDTH))
    det["heat"]["c2"]["w"] = det["heat"]["c2"]["w"] * 1000.0
    det["heat"]["c2"]["b"] = det["heat"]["c2"]["b"] - 1.0  # sparse peaks
    det["wh"]["c2"]["w"] = det["wh"]["c2"]["w"] * 1000.0
    acc = _np_tree(jam.accmodel_init(jax.random.PRNGKey(1), WIDTH))
    acc["c3"]["w"] = acc["c3"]["w"] * 500.0
    return det, acc


@pytest.fixture(scope="module")
def ref_models(weights):
    return (jv.FinalDNN("detection", jax.tree_util.tree_map(jnp.asarray,
                                                             weights[0])),
            jam.AccModel(jax.tree_util.tree_map(jnp.asarray, weights[1])))


@pytest.fixture(scope="module")
def port_models(weights):
    return (final_dnn_from_numpy("detection", weights[0], device="cpu"),
            accmodel_from_numpy(weights[1], device="cpu"))


@pytest.fixture(scope="module")
def fleet_frames():
    return np.stack([make_scene("dashcam", seed=s, T=T, H=H, W=W).frames
                     for s in SEEDS])


@pytest.fixture(scope="module")
def ref_fleet(ref_models, fleet_frames):
    dnn, am = ref_models
    refs = [jp.make_reference(f, dnn, qp_hi=30) for f in fleet_frames]
    run = JMultiStreamEngine(dnn, am, config=JEngineConfig(
        qcfg=jq.QualityConfig(**QCFG), impl="exact")).run(
        fleet_frames, refs=refs)
    return refs, run


@pytest.fixture(scope="module")
def port_refs(port_models, fleet_frames):
    return [make_reference(f, port_models[0], qp_hi=30)
            for f in fleet_frames]


# ---------------------------------------------------------------------------
# uplink and pipeline accounting (host numpy, bit-equal)
# ---------------------------------------------------------------------------
def test_network_config_shared_matches_reference():
    for uplink, n, rtt in ((2.5e6, 8, 0.1), (1e6, 3, 0.05), (7.7e5, 1, 0.2)):
        got = tp.NetworkConfig.shared(uplink, n, rtt_s=rtt)
        want = jp.NetworkConfig.shared(uplink, n, rtt_s=rtt)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(tp.NetworkConfig()) == \
        dataclasses.asdict(jp.NetworkConfig())


@pytest.mark.parametrize("sizes", [
    [1000.0, 2000.0, 4000.0, 8000.0],
    [3000.0, 3000.0, 1000.0, 3000.0],   # ties keep input order
    [0.0, 0.0, 5e5],
    [12345.678],
    [],
])
@pytest.mark.parametrize("shared", [True, False])
def test_shared_stream_delays_bit_equal(sizes, shared):
    n = max(len(sizes), 1)
    kw = dict(bandwidth_bps=3.3e5, rtt_s=0.08)
    if shared:
        got = tp.shared_stream_delays(sizes, tp.NetworkConfig.shared(2.5e6, n))
        want = jp.shared_stream_delays(sizes, jp.NetworkConfig.shared(2.5e6,
                                                                      n))
    else:  # no uplink_bps: bandwidth * N stands in for it
        got = tp.shared_stream_delays(sizes, tp.NetworkConfig(**kw))
        want = jp.shared_stream_delays(sizes, jp.NetworkConfig(**kw))
    assert got == want
    assert all(type(d) is float for d in got)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.floats(min_value=0.0, max_value=1e7), min_size=1,
                max_size=12),
       st.floats(min_value=1e4, max_value=1e9))
def test_shared_stream_delays_property(sizes, uplink):
    """Any sizes and uplink: bit-equal to the reference, never slower than
    the fixed equal split, never faster than a dedicated uplink, and the
    last finisher pays the serialized total."""
    net_t = tp.NetworkConfig.shared(uplink, len(sizes))
    got = tp.shared_stream_delays(sizes, net_t)
    assert got == jp.shared_stream_delays(
        sizes, jp.NetworkConfig.shared(uplink, len(sizes)))
    for b, d in zip(sizes, got):
        assert d >= b * 8.0 / uplink + net_t.rtt_s / 2 - 1e-9
        assert d <= tp.stream_delay(b, net_t) * (1 + 1e-12) + 1e-12
    total = sum(sizes) * 8.0 / uplink + net_t.rtt_s / 2
    assert max(got) == pytest.approx(total, rel=1e-9, abs=1e-12)


@settings(max_examples=30, deadline=None)
@given(st.lists(st.floats(min_value=0.0, max_value=10.0), min_size=0,
                max_size=8),
       st.floats(min_value=0.0, max_value=10.0))
def test_pipeline_makespan_and_fleet_timing_match_reference(cams, srv):
    servers = [srv * (i % 3) for i in range(len(cams))]
    assert tp.pipeline_makespan(cams, servers) == \
        jp.pipeline_makespan(cams, servers)
    got = tp.FleetTiming(list(cams), servers, [0.5] * len(cams), wall_s=3.0)
    want = jp.FleetTiming(list(cams), servers, [0.5] * len(cams), wall_s=3.0)
    assert got.summary() == want.summary()
    assert got.overlap_saving_s == want.overlap_saving_s
    merged = tp.FleetTiming.merge_concurrent([got, got])
    merged_ref = jp.FleetTiming.merge_concurrent([want, want])
    assert merged.summary() == merged_ref.summary()


# ---------------------------------------------------------------------------
# QP maps and frame drop
# ---------------------------------------------------------------------------
def _scores(n=3, seed=0):
    rng = np.random.RandomState(seed)
    return rng.rand(n, H // 16, W // 16).astype(np.float32)


def test_qp_maps_from_scores_batched_matches_reference():
    s = _scores()
    cfg = dict(alpha=0.55, gamma=2, qp_hi=28, qp_lo=44)
    got = tq.qp_maps_from_scores_batched(torch.from_numpy(s),
                                         tq.QualityConfig(**cfg))
    want = jq.qp_maps_from_scores_batched(jnp.asarray(s),
                                          jq.QualityConfig(**cfg))
    assert tuple(got[0].shape) == (3, 1, H // 16, W // 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("gamma", [0, 1, 3])
def test_qp_maps_from_knobs_batched_matches_reference(gamma):
    s = _scores(seed=1)
    knobs = np.array([0.4, 26.0, 47.0, 0.0], np.float32)
    got = tq.qp_maps_from_knobs_batched(torch.from_numpy(s),
                                        torch.from_numpy(knobs), gamma)
    want = jq.qp_maps_from_knobs_batched(jnp.asarray(s), jnp.asarray(knobs),
                                         gamma)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _drop_chunk():
    """Frames 2, 3 and 6 repeat their predecessors (feature 0); the rest
    change by clearly more than the thresholds below."""
    rng = np.random.RandomState(4)
    frames = [rng.rand(32, 48, 3).astype(np.float32)]
    for t in range(1, 8):
        frames.append(frames[-1] if t in (2, 3, 6)
                      else np.clip(frames[-1] + 0.1 * rng.randn(32, 48, 3),
                                   0, 1).astype(np.float32))
    return np.stack(frames)


@pytest.mark.parametrize("thresh", [0.0, 0.05, 1e9])
def test_soft_drop_previous_matches_reference(thresh):
    chunk = _drop_chunk()
    feat_t = tpol.frame_diff_feature(torch.from_numpy(chunk))
    feat_j = jpol.frame_diff_feature(jnp.asarray(chunk))
    np.testing.assert_allclose(feat_t.numpy(), np.asarray(feat_j),
                               rtol=1e-6)
    got, keep = tpol.soft_drop_previous(torch.from_numpy(chunk),
                                        torch.tensor(thresh))
    want, keep_j = jpol.soft_drop_previous(jnp.asarray(chunk), thresh)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_j))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool(keep[0])


# ---------------------------------------------------------------------------
# batched accuracy
# ---------------------------------------------------------------------------
def _lane_tree(task, seed, n=3, t=4, hs=12, ws=20):
    rng = np.random.RandomState(seed)
    if task == "detection":
        heat = (rng.randn(n, t, hs, ws, 1) * 3 - 2).astype(np.float32)
        out = {"heat": heat,
               "wh": rng.uniform(0, 4, (n, t, hs, ws, 2)).astype(np.float32),
               "off": np.zeros((n, t, hs, ws, 2), np.float32)}
        flat = {"heat": jnp.asarray(heat.reshape((n * t, hs, ws, 1)))}
        out["keep"] = np.array(jv.detection_keep_heat(flat)).reshape(
            n, t, hs, ws)
        return out
    if task == "segmentation":
        return {"seg": rng.randn(n, t, hs, ws, 2).astype(np.float32)}
    return {"kp": (rng.randn(n, t, hs, ws, 5) * 2).astype(np.float32)}


@pytest.mark.parametrize("task", ["detection", "segmentation", "keypoint"])
def test_accuracy_batched_bit_equal(task):
    """Shared numpy lane trees: the port's batched scorer equals the
    reference's, and each lane equals the port's per-lane ``accuracy``."""
    out, ref = _lane_tree(task, 1), _lane_tree(task, 2)
    # some lanes score their own output against itself (accuracy 1)
    for k in out:
        ref[k][1] = out[k][1]
    dnn = tv.FinalDNN(task, 8, device="cpu")
    got = dnn.accuracy_batched(out, ref)
    want = jv.FinalDNN(task, {}).accuracy_batched(out, ref)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got[1] == 1.0
    for i in range(got.shape[0]):
        lane = {k: v[i] for k, v in out.items()}
        lane_ref = {k: torch.from_numpy(v[i]) for k, v in ref.items()}
        assert dnn.accuracy(lane, lane_ref) == got[i]


def test_detection_batched_without_keep_runs_the_nms():
    out, ref = _lane_tree("detection", 3), _lane_tree("detection", 4)
    bare = {k: v for k, v in out.items() if k != "keep"}
    np.testing.assert_array_equal(tv.detection_f1_batched(bare, ref),
                                  tv.detection_f1_batched(out, ref))
    assert tv.FinalDNN("detection", 8, device="cpu") \
        .supports_device_accuracy is False
    assert tv.FinalDNN("keypoint", 8, device="cpu").supports_device_accuracy


# ---------------------------------------------------------------------------
# the fleet's camera and server steps
# ---------------------------------------------------------------------------
def _heads(fleet_frames):
    return fleet_frames[:, :10]


def _assert_step_matches(got, want, dec_atol=DEC_ATOL):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=dec_atol)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=BYTES_RTOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=1e-5)


@pytest.mark.parametrize("impl", ["exact", "fused_exact", "pallas"])
def test_camera_fleet_step_matches_reference_exact(impl, ref_models,
                                                   port_models, fleet_frames):
    """Backends with the exact encoder's semantics against the reference
    step's ``exact`` (on the CPU the kernel backends take their plain
    versions)."""
    chunks = _heads(fleet_frames)
    want = jsteps.make_camera_fleet_step(
        ref_models[1], jq.QualityConfig(**QCFG), impl="exact")(
        jnp.asarray(chunks))
    got = tsteps.make_camera_fleet_step(
        port_models[1], tq.QualityConfig(**QCFG), impl=impl)(
        torch.from_numpy(chunks))
    _assert_step_matches(got, want)


@pytest.mark.parametrize("clip_refs", [False, True])
def test_camera_fleet_step_fused_matches_reference_kernel(
        clip_refs, ref_models, port_models, fleet_frames):
    """The scores path against the reference's own: sigmoid scores,
    ``dilate_scores``, then per stream ``encode_chunk_fused_scores``
    through the Pallas scores kernel in interpret mode."""
    chunks = _heads(fleet_frames)
    qcfg = jq.QualityConfig(**QCFG)
    scores = jax.nn.sigmoid(jam.accmodel_apply(ref_models[1].params,
                                               jnp.asarray(chunks[:, 0])))
    pooled = jq.dilate_scores(scores, GAMMA)
    knobs = jnp.array([ALPHA, 30.0, float(QP_LO)], jnp.float32)
    outs = [jops.encode_chunk_fused_scores(jnp.asarray(c), p, knobs,
                                           clip_refs, impl="interpret")
            for c, p in zip(chunks, pooled)]
    want = (np.stack([np.asarray(o[0]) for o in outs]),
            np.stack([np.asarray(o[1]) for o in outs]), scores)
    impl = "fused_exact" if clip_refs else "fused"
    got = tsteps.make_camera_fleet_step(
        port_models[1], tq.QualityConfig(**qcfg.__dict__), impl=impl)(
        torch.from_numpy(chunks))
    _assert_step_matches(got, want)


@pytest.mark.parametrize("impl", ["exact", "fused_exact"])
@pytest.mark.parametrize("mask", [False, True])
def test_camera_fleet_step_knobs_and_mask_match_reference(
        impl, mask, ref_models, port_models, fleet_frames):
    """The knob step (alpha, qp_hi, qp_lo, drop threshold as a tensor)
    and the lane-mask step against the reference's ``exact`` step with
    the same knobs and mask; masked lanes report zero bytes."""
    chunks = _heads(fleet_frames).copy()
    chunks[1, 4] = chunks[1, 3]  # a repeated frame for the drop to catch
    knobs = np.array([0.6, 28.0, 44.0, 0.01], np.float32)
    active = np.array([1, 0, 1], np.int32)
    jargs = ((jnp.asarray(active),) if mask else ()) + (jnp.asarray(knobs),)
    targs = ((torch.from_numpy(active),) if mask else ()) \
        + (torch.from_numpy(knobs),)
    want = jsteps.make_camera_fleet_step(
        ref_models[1], jq.QualityConfig(**QCFG), impl="exact", knobs=True,
        mask=mask)(jnp.asarray(chunks), *jargs)
    got = tsteps.make_camera_fleet_step(
        port_models[1], tq.QualityConfig(**QCFG), impl=impl, knobs=True,
        mask=mask)(torch.from_numpy(chunks), *targs)
    _assert_step_matches(got, want)
    if mask:
        assert float(got[1][1].abs().sum()) == 0.0
        assert float(got[1][0].sum()) > 0


def test_camera_fleet_step_mask_without_knobs(port_models, fleet_frames):
    chunks = torch.from_numpy(_heads(fleet_frames))
    plain = tsteps.make_camera_fleet_step(
        port_models[1], tq.QualityConfig(**QCFG), impl="fused")(chunks)
    masked = tsteps.make_camera_fleet_step(
        port_models[1], tq.QualityConfig(**QCFG), impl="fused", mask=True)(
        chunks, torch.tensor([0, 1, 1]))
    assert torch.equal(masked[1][0], torch.zeros_like(masked[1][0]))
    assert torch.equal(masked[1][1:], plain[1][1:])
    assert torch.equal(masked[0], plain[0])


def test_server_fleet_step_matches_reference(ref_models, port_models,
                                             fleet_frames):
    chunks = _heads(fleet_frames)
    want = jsteps.make_server_fleet_step(ref_models[0])(jnp.asarray(chunks))
    got = tsteps.make_server_fleet_step(port_models[0])(
        torch.from_numpy(chunks))
    assert set(got) == set(want) == {"heat", "wh", "off", "keep"}
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4)


def test_steps_refuse_a_mesh(port_models):
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        tsteps.make_camera_fleet_step(port_models[1], tq.QualityConfig(),
                                      mesh=object())
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        tsteps.make_server_fleet_step(port_models[0], mesh=object())


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------
def test_fleet_seeds_are_well_posed(ref_models, port_models, fleet_frames,
                                    ref_fleet, port_refs):
    """Every decision of the reference fleet run lies more than 1e-5 from
    its threshold, D(H) agrees between the packages, and the run has
    accuracies below 1 and both QP levels."""
    dnn, am = ref_models
    qcfg = jq.QualityConfig(**QCFG)
    margins = []
    for frames in fleet_frames:
        for s in range(0, T, 10):
            chunk = jnp.asarray(frames[s:s + 10])
            scores = am.scores(chunk[:1])
            margins.append(float(jnp.abs(scores - ALPHA).min()))
            qmap, _ = jq.qp_map_from_scores(scores[0], qcfg)
            dec, _ = jc.encode_chunk(chunk, qmap[None])
            hq, _ = jc.encode_chunk(chunk, jnp.full_like(qmap[None], 30.0))
            dets = []
            for o in (dnn.predict(dec), dnn.predict(hq)):
                heat = jax.nn.sigmoid(o["heat"])
                pooled = jax.lax.reduce_window(
                    heat, -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 1, 1, 1),
                    "SAME")
                live = (heat < pooled) & (heat >= 0.3 - MARGIN)
                margins.append(float(jnp.abs(heat - (pooled - 1e-6))[
                    live].min(initial=1.0)))
                keep = np.asarray(jv.detection_keep_heat(o))
                margins.append(float(np.abs(keep[keep > 0] - 0.3).min()))
                dets.append(jv.decode_detections(o))
            for d_frame, r_frame in zip(*dets):
                for a in d_frame:
                    for b in r_frame:
                        iou = jv._iou(a, b)
                        if iou > 0:
                            margins.append(abs(iou - 0.5))
    assert min(margins) > MARGIN
    for got_s, want_s in zip(port_refs, ref_fleet[0]):
        for got, want in zip(got_s, want_s):
            for k in want:
                np.testing.assert_allclose(got[k].numpy(),
                                           np.asarray(want[k]), atol=1e-4)
    accs = [c.accuracy for r in ref_fleet[1].streams for c in r.chunks]
    assert min(accs) < 1.0
    share = float((am.scores(jnp.asarray(fleet_frames[:, 0])) >= ALPHA)
                  .mean())
    assert 0.1 < share < 0.9


def _assert_fleet_matches(got, want):
    assert got.n_streams == want.n_streams == len(SEEDS)
    for gs, ws in zip(got.streams, want.streams):
        assert gs.method == ws.method
        assert len(gs.chunks) == len(ws.chunks) == T // 10
        for g, w in zip(gs.chunks, ws.chunks):
            assert g.accuracy == pytest.approx(w.accuracy, abs=ACC_ATOL)
            assert g.bytes == pytest.approx(w.bytes, rel=BYTES_RTOL)
            assert g.stream_s == pytest.approx(w.stream_s, rel=BYTES_RTOL)
            assert g.ci == w.ci and g.queue_s == w.queue_s == 0.0


@pytest.mark.parametrize("detail", ["chunks", "legacy"])
@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("impl", ["exact", "fused_exact"])
def test_fleet_run_matches_reference(impl, overlap, detail, port_models,
                                     fleet_frames, ref_fleet, port_refs):
    dnn, am = port_models
    got = MultiStreamEngine(dnn, am, config=EngineConfig(
        qcfg=tq.QualityConfig(**QCFG), impl=impl, overlap=overlap,
        detail=detail), device="cpu").run(fleet_frames, refs=port_refs)
    want = ref_fleet[1]
    _assert_fleet_matches(got, want)
    assert set(got.summary()) == set(want.summary())
    assert got.served_cis == want.served_cis == [0, 1]
    t = got.timing
    assert len(t.camera_s) == len(t.server_s) == len(t.host_s) == T // 10
    assert t.wall_s > 0 and all(c > 0 for c in t.camera_s)


def test_fleet_run_without_refs_matches_reference(ref_models, port_models,
                                                  fleet_frames):
    """refs=None: the reference outputs are the server DNN on the raw
    chunk, a second batched server pass per chunk."""
    frames = fleet_frames[:2, :10]
    want = JMultiStreamEngine(*ref_models, config=JEngineConfig(
        qcfg=jq.QualityConfig(**QCFG), impl="exact")).run(frames)
    got = MultiStreamEngine(*port_models, config=EngineConfig(
        qcfg=tq.QualityConfig(**QCFG), impl="exact"), device="cpu").run(
        torch.from_numpy(frames))
    for gs, ws in zip(got.streams, want.streams):
        for g, w in zip(gs.chunks, ws.chunks):
            assert g.accuracy == pytest.approx(w.accuracy, abs=ACC_ATOL)
            assert g.bytes == pytest.approx(w.bytes, rel=BYTES_RTOL)


def test_fleet_matches_sequential_engines(port_models, fleet_frames,
                                          port_refs):
    """Each fleet stream equals a single-stream engine run on its frames
    (the exact encoder codes each stream alone), and the fused fleet's
    one stream-batched launch equals per-stream fused runs."""
    dnn, am = port_models
    net = tp.NetworkConfig.shared(2.5e6, len(SEEDS))
    for impl in ("exact", "fused"):
        fleet = MultiStreamEngine(dnn, am, config=EngineConfig(
            qcfg=tq.QualityConfig(**QCFG), impl=impl, net=net),
            device="cpu").run(fleet_frames, refs=port_refs)
        for i, frames in enumerate(fleet_frames):
            seq = StreamingEngine(dnn, net=net, impl=impl, device="cpu").run(
                AccMPEGPolicy(am, tq.QualityConfig(**QCFG)), frames,
                refs=port_refs[i])
            for cf, cs in zip(fleet.streams[i].chunks, seq.chunks):
                assert cf.accuracy == cs.accuracy
                assert cf.bytes == pytest.approx(cs.bytes, rel=1e-6)


def test_fleet_result_summary_and_sim_encode(port_models, fleet_frames,
                                             port_refs):
    dnn, am = port_models
    res = MultiStreamEngine(dnn, am, config=EngineConfig(
        qcfg=tq.QualityConfig(**QCFG), impl="fused", sim_encode_s=0.25,
        depth=1), device="cpu").run(fleet_frames, refs=port_refs)
    assert isinstance(res, FleetResult)
    assert all(c.encode_s == 0.25 for r in res.streams for c in r.chunks)
    s = res.summary()
    assert s["n_streams"] == len(SEEDS)
    assert s["chunks_per_s"] == pytest.approx(
        len(SEEDS) / np.mean(res.camera_s))
    assert s["p95_delay_s"] >= res.p90_delay > 0.25


@pytest.mark.parametrize("field,value", [
    ("mesh", "auto"), ("trace", object()), ("controller", object()),
    ("autoscaler", object()), ("aggregate", object()),
    ("tenants", (object(),)), ("tenant_of", {0: 0}),
    ("detail", "windowed"),
])
def test_unported_config_fields_raise(field, value):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        EngineConfig(**{field: value})


def test_engine_config_mirrors_the_reference():
    ours = {f.name: f.default for f in dataclasses.fields(EngineConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JEngineConfig)}
    assert list(ours) == list(theirs)
    for name, default in theirs.items():
        if name == "qcfg":
            assert dataclasses.asdict(ours[name]) == \
                dataclasses.asdict(default)
        else:
            assert ours[name] == default, name
    with pytest.raises(ValueError, match="detail"):
        EngineConfig(detail="nope")
    with pytest.raises(ValueError, match="chunk_size"):
        EngineConfig(chunk_size=0)
    with pytest.raises(ValueError, match="depth"):
        EngineConfig(depth=0)
    with pytest.raises(dataclasses.FrozenInstanceError):
        EngineConfig().impl = "exact"


def test_fleet_engine_defaults_to_cuda_and_refuses_without_it(port_models):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiStreamEngine(*port_models)
    with pytest.raises(ValueError, match="unknown chunk encoder"):
        MultiStreamEngine(*port_models, config=EngineConfig(impl="nope"),
                          device="cpu")


def test_batched_encoders_match_per_stream(fleet_frames):
    frames = torch.from_numpy(fleet_frames[:, :10])
    qmaps = torch.stack([torch.full((1, H // 16, W // 16), q)
                         for q in (32.0, 36.0, 40.0)])
    for impl in ("exact", "fast", "fused_exact"):
        dec, pbytes = tc.encode_chunk_batched(frames, qmaps, impl=impl)
        assert tuple(pbytes.shape) == (3, 10)
        for i in range(3):
            d_i, b_i = tc.CHUNK_ENCODERS[impl](frames[i], qmaps[i])
            assert torch.equal(dec[i], d_i) and torch.equal(pbytes[i], b_i)
    dec_u, bytes_u = tc.encode_chunk_uniform_batched(frames, 36)
    assert torch.equal(bytes_u[1], tc.encode_chunk_batched(frames, qmaps)[1][1])
    want = jc.encode_chunk_batched(jnp.asarray(fleet_frames[:, :10]),
                                   jnp.asarray(qmaps.numpy()), impl="exact")
    np.testing.assert_allclose(tc.encode_chunk_batched(frames, qmaps)[0]
                               .numpy(), np.asarray(want[0]), atol=DEC_ATOL)
    np.testing.assert_allclose(tc.encode_chunk_batched(frames, qmaps)[1]
                               .numpy(), np.asarray(want[1]),
                               rtol=BYTES_RTOL)
