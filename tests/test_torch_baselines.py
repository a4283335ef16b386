"""The paper's baselines in the port against the reference, on the CPU:
DDS, EAAR, Reducto, Vigil, SiEVE, Reducto+AccMPEG and the uniform
building block, each run through both packages' ``StreamingEngine`` on
the same seeded scene with the same weights (the reference's, carried
across). Per chunk, accuracy agrees within 1e-6, bytes within rtol 1e-3
and ``extra_rtt_s`` exactly; timing fields are excluded. The port runs
under ``impl="exact"`` and ``"fused_exact"`` (on the CPU the kernel
backend takes its plain version); the reference under ``"exact"``.

Weights follow ``tests/test_torch_engine.py``: random-init detectors with
their heads' last layers scaled and the heat bias lowered, so that peaks
are sparse and detections well spread; the server and the camera detector
(Vigil, SiEVE) are two such nets. Every decision of the reference's runs
is recorded and the seed is kept only if none lies within a margin of its
threshold (``test_seed_is_well_posed``): detection scores and NMS
comparisons (1e-5), IoUs against 0.5 (1e-5), box edges against the
macroblock grid that ``boxes_to_mask`` floors and ceils to (1e-3 px),
Reducto's change feature (1e-5), SiEVE's presence deltas (1e-5) and
AccModel scores against alpha (1e-5). Scene seed 34 is
``tests/test_torch_engine.py``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.engine.policies as jpol
import repro.vision.dnn as jv
from repro.baselines import baselines as jb
from repro.core import accmodel as jam
from repro.core.pipeline import make_reference as j_make_reference
from repro.core.quality import QualityConfig as JQualityConfig
from repro.data.video import make_scene
from repro.engine import ReductoAccMPEGPolicy as JReductoAccMPEGPolicy
from repro.engine import SiEVEPolicy as JSiEVEPolicy
from repro.engine import StreamingEngine as JStreamingEngine
from repro.engine import class_presence as j_class_presence
from repro_torch import baselines as tb
from repro_torch.core.pipeline import NetworkConfig, make_reference
from repro_torch.core.quality import QualityConfig
from repro_torch.engine import (EAARPolicy, ReductoAccMPEGPolicy,
                                SiEVEPolicy, StreamingEngine, boxes_to_mask,
                                class_presence, frame_diff_feature)
from repro_torch.engine.policies import (_server_region_mask,
                                         reconstruct_dropped)
from repro_torch.weights import accmodel_from_numpy, final_dnn_from_numpy

H, W, T, WIDTH = 96, 160, 20, 8
SEED = 34
QCFG = dict(alpha=0.7, gamma=1, qp_lo=46)
REDUCTO_THRESH, SIEVE_DELTA = 0.4, 6e-4
ACC_ATOL, BYTES_RTOL = 1e-6, 1e-3
MARGIN, EDGE_MARGIN = 1e-5, 1e-3
# below every decode threshold (0.15 DDS, 0.2 EAAR, 0.25 Vigil, 0.3
# accuracy): sigmoid(-2.5) = 0.076, so flat heat is never a candidate
HEAT_BIAS = 2.5
POLICIES = ("uniform", "dds", "eaar", "reducto", "vigil", "sieve",
            "reducto_accmpeg")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch calls: the suite's
    workers share the machine's cores, and torch's default of a thread
    per core makes these small eager ops wait on each other's spinning
    pools (tens of times slower under the full suite). Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _detector(key, heat_scale, wh_scale):
    det = _np_tree(jv.init_net("detection", jax.random.PRNGKey(key), WIDTH))
    det["heat"]["c2"]["w"] = det["heat"]["c2"]["w"] * heat_scale
    det["heat"]["c2"]["b"] = det["heat"]["c2"]["b"] - HEAT_BIAS
    det["wh"]["c2"]["w"] = det["wh"]["c2"]["w"] * wh_scale
    return det


@pytest.fixture(scope="module")
def weights():
    """Server (key 2) and camera detector (key 3), their scales set so
    that the heat logits' 99th percentile on this scene lies near 0 and
    the box sizes (wh) near 2-3 cells: 2-7 detections a frame at each
    threshold."""
    acc = _np_tree(jam.accmodel_init(jax.random.PRNGKey(1), WIDTH))
    acc["c3"]["w"] = acc["c3"]["w"] * 500.0
    return _detector(2, 6000.0, 8000.0), _detector(3, 45.0, 40.0), acc


@pytest.fixture(scope="module")
def scene():
    return make_scene("dashcam", seed=SEED, T=T, H=H, W=W)


@pytest.fixture(scope="module")
def ref_models(weights):
    det, cam, acc = (jax.tree_util.tree_map(jnp.asarray, w) for w in weights)
    return (jv.FinalDNN("detection", det), jv.FinalDNN("detection", cam),
            jam.AccModel(acc))


@pytest.fixture(scope="module")
def port_models(weights):
    det, cam, acc = weights
    return (final_dnn_from_numpy("detection", det, device="cpu"),
            final_dnn_from_numpy("detection", cam, device="cpu"),
            accmodel_from_numpy(acc, device="cpu"))


def _ref_run(name, frames, models, refs):
    dnn, cam, am = models
    if name == "uniform":
        return jb.run_uniform(frames, dnn, 38, refs=refs)
    if name == "dds":
        return jb.run_dds(frames, dnn, refs=refs)
    if name == "eaar":
        return jb.run_eaar(frames, dnn, refs=refs)
    if name == "reducto":
        return jb.run_reducto(frames, dnn, thresh=REDUCTO_THRESH, refs=refs)
    if name == "vigil":
        return jb.run_vigil(frames, dnn, cam, refs=refs)
    if name == "sieve":
        return JStreamingEngine(dnn).run(
            JSiEVEPolicy(cam, qp=32, delta=SIEVE_DELTA), frames, refs=refs)
    return JStreamingEngine(dnn).run(
        JReductoAccMPEGPolicy(am, JQualityConfig(**QCFG),
                              thresh=REDUCTO_THRESH), frames, refs=refs)


def _port_run(name, frames, models, refs, impl):
    dnn, cam, am = models
    if impl == "exact":  # the run_* entry points take the default backend
        if name == "uniform":
            return tb.run_uniform(frames, dnn, 38, refs=refs, device="cpu")
        if name == "dds":
            return tb.run_dds(frames, dnn, refs=refs, device="cpu")
        if name == "eaar":
            return tb.run_eaar(frames, dnn, refs=refs, device="cpu")
        if name == "reducto":
            return tb.run_reducto(frames, dnn, thresh=REDUCTO_THRESH,
                                  refs=refs, device="cpu")
        if name == "vigil":
            return tb.run_vigil(frames, dnn, cam, refs=refs, device="cpu")
    from repro_torch import engine as te

    policy = {
        "uniform": lambda: te.UniformPolicy(38),
        "dds": te.DDSPolicy, "eaar": te.EAARPolicy,
        "reducto": lambda: te.ReductoPolicy(thresh=REDUCTO_THRESH),
        "vigil": lambda: te.VigilPolicy(cam),
        "sieve": lambda: SiEVEPolicy(cam, qp=32, delta=SIEVE_DELTA),
        "reducto_accmpeg": lambda: ReductoAccMPEGPolicy(
            am, QualityConfig(**QCFG), thresh=REDUCTO_THRESH),
    }[name]()
    return StreamingEngine(dnn, impl=impl, device="cpu").run(
        policy, frames, refs=refs)


@pytest.fixture(scope="module")
def ref_runs(ref_models, scene):
    """The reference's runs of every policy, with every detection decode
    and F1 match recorded for the margin check."""
    decodes, matches = [], []
    decode, f1 = jv.decode_detections, jv.detection_f1

    def rec_decode(out, thresh=0.3, topk=50):
        decodes.append((out, thresh))
        return decode(out, thresh=thresh, topk=topk)

    def rec_f1(dets, refs, iou_thresh=0.5):
        matches.append((dets, refs))
        return f1(dets, refs, iou_thresh=iou_thresh)

    refs = j_make_reference(scene.frames, ref_models[0], qp_hi=30)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jv, "decode_detections", rec_decode)
        mp.setattr(jv, "detection_f1", rec_f1)
        mp.setattr(jpol, "decode_detections", rec_decode)
        runs = {name: _ref_run(name, scene.frames, ref_models, refs)
                for name in POLICIES}
    return refs, runs, decodes, matches


@pytest.fixture(scope="module")
def port_refs(port_models, scene):
    return make_reference(scene.frames, port_models[0], qp_hi=30)


def _detection_margins(out, thresh):
    """Distances of a decode's decisions to their thresholds: NMS against
    its 1e-6 slack, scores against ``thresh``, box edges against the
    16-pixel grid."""
    heat = np.asarray(jax.nn.sigmoid(out["heat"]))
    pooled = np.asarray(jax.lax.reduce_window(
        jnp.asarray(heat), -jnp.inf, jax.lax.max, (1, 3, 3, 1),
        (1, 1, 1, 1), "SAME"))
    live = (heat < pooled) & (heat >= min(thresh, 0.3) - MARGIN)
    nms = np.abs(heat - (pooled - 1e-6))[live]
    keep = np.asarray(jv.detection_keep_heat(out))
    score = np.abs(keep[keep > 0] - thresh)
    edges = [abs(e / 16.0 - round(e / 16.0)) * 16.0
             for f in jv.decode_detections(out, thresh=thresh)
             for d in f for e in d[:4]]
    return (float(nms.min(initial=1.0)), float(score.min(initial=1.0)),
            min(edges, default=1.0))


def _chunks(frames):
    return [jnp.asarray(frames[s:s + 10]) for s in range(0, T, 10)]


def test_seed_is_well_posed(ref_models, ref_runs, scene):
    """No decision of the reference's runs lies within its margin, the
    decodes of DDS (0.15), EAAR (0.2) and Vigil (0.25) find boxes, Reducto
    and SiEVE drop some frames and keep others, and accuracy is neither
    always 0 nor always 1."""
    _, cam, am = ref_models
    _, runs, decodes, matches = ref_runs
    nms, score, edge = zip(*(_detection_margins(o, t) for o, t in decodes))
    assert min(nms) > MARGIN and min(score) > MARGIN
    assert min(edge) > EDGE_MARGIN
    ious = [abs(jv._iou(a, b) - 0.5) for dets, refs in matches
            for df, rf in zip(dets, refs) for a in df for b in rf
            if jv._iou(a, b) > 0]
    assert min(ious) > MARGIN
    for thresh in (0.15, 0.2, 0.25):
        assert any(d for o, t in decodes if t == thresh
                   for d in jv.decode_detections(o, thresh=thresh)), thresh
    n_dropped = {"reducto": 0, "sieve": 0}
    for chunk in _chunks(scene.frames):
        feat = np.asarray(jpol.frame_diff_feature(chunk))
        assert np.abs(feat - REDUCTO_THRESH).min() > MARGIN
        n_dropped["reducto"] += int((feat[1:] < REDUCTO_THRESH).sum())
        pres = np.asarray(j_class_presence(cam.predict(chunk)))
        last = pres[0]
        for t in range(1, len(pres)):
            delta = np.abs(pres[t] - last).max()
            assert abs(delta - SIEVE_DELTA) > MARGIN
            if delta >= SIEVE_DELTA:
                last = pres[t]
            else:
                n_dropped["sieve"] += 1
        scores = np.asarray(am.scores(chunk[:1]))
        assert np.abs(scores - QCFG["alpha"]).min() > MARGIN
    assert all(n > 0 for n in n_dropped.values()), n_dropped
    assert all(n < T - 2 for n in n_dropped.values()), n_dropped
    accs = [c.accuracy for r in runs.values() for c in r.chunks]
    assert min(accs) < 1.0 and max(accs) > 0.0, accs


@pytest.mark.parametrize("impl", ["exact", "fused_exact"])
@pytest.mark.parametrize("name", POLICIES)
def test_baseline_matches_reference(name, impl, ref_runs, port_models,
                                    port_refs, scene):
    want = ref_runs[1][name]
    got = _port_run(name, scene.frames, port_models, port_refs, impl)
    assert got.method == want.method
    assert len(got.chunks) == len(want.chunks) == T // 10
    for g, w in zip(got.chunks, want.chunks):
        assert g.accuracy == pytest.approx(w.accuracy, abs=ACC_ATOL)
        assert g.bytes == pytest.approx(w.bytes, rel=BYTES_RTOL)
        assert g.stream_s == pytest.approx(w.stream_s, rel=BYTES_RTOL)
        assert g.extra_rtt_s == w.extra_rtt_s
        assert g.queue_s == w.queue_s == 0.0
        assert g.ci == w.ci
    assert set(got.summary()) == set(want.summary())
    if name == "dds":
        assert all(c.extra_rtt_s == NetworkConfig().rtt_s
                   for c in got.chunks)


def test_eaar_resets_its_mask_between_runs(port_models, port_refs, scene):
    dnn = port_models[0]
    policy = EAARPolicy()
    engine = StreamingEngine(dnn, device="cpu")
    first = engine.run(policy, scene.frames, refs=port_refs)
    assert policy.prev_mask is not None
    second = engine.run(policy, scene.frames, refs=port_refs)
    for a, b in zip(first.chunks, second.chunks):
        assert a.accuracy == b.accuracy and a.bytes == b.bytes
    policy.reset()
    assert policy.prev_mask is None


def test_boxes_to_mask_matches_reference():
    """Negative, out-of-frame and edge-aligned boxes, with and without
    growth: the same integer arithmetic, including a negative end index,
    which slices from the end in both packages."""
    boxes = [(-20.0, -5.5, 10.0, 12.0, 0.9), (150.0, 80.0, 400.0, 300.0),
             (31.9, 32.0, 48.0, 47.99), (-50.0, -40.0, -20.0, -18.0),
             (64.0, 16.0, 64.0, 16.0), (-3.5, 70.2, 5.0, 95.0, 0.1)]
    for grow in (0, 1, 2):
        for some in (boxes, boxes[:1], boxes[3:4], []):
            want = np.asarray(jb.boxes_to_mask(some, 6, 10, grow))
            got = boxes_to_mask(some, 6, 10, grow, device="cpu")
            assert got.dtype == torch.bool and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("task", ["segmentation", "keypoint"])
def test_server_region_mask_matches_reference(task):
    """The dense-head branch: 75th percentile of the output's activity,
    tiled up to the macroblock grid, dilated by ``grow``."""
    rng = np.random.RandomState(5)
    C = 2 if task == "segmentation" else 5
    out = rng.randn(3, H // 8, W // 8, C).astype(np.float32)
    key = "seg" if task == "segmentation" else "kp"

    class Server:
        def __init__(self, device):
            self.task, self.device = task, device

    for grow in (0, 1, 2):
        want = jpol._server_region_mask(Server(None), {key: jnp.asarray(out)},
                                        H // 16, W // 16, grow, 0.15)
        got = _server_region_mask(Server(torch.device("cpu")),
                                  {key: torch.from_numpy(out)}, H // 16,
                                  W // 16, grow, 0.15)
        assert got.device.type == "cpu" and got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0 < int(got.sum()) < got.numel() or grow > 0


@pytest.mark.parametrize("key,C", [("heat", 1), ("seg", 2), ("kp", 5)])
def test_class_presence_matches_reference(key, C):
    out = np.random.RandomState(6).randn(4, 12, 20, C).astype(np.float32)
    want = np.asarray(j_class_presence({key: jnp.asarray(out)}))
    got = class_presence({key: torch.from_numpy(out)})
    assert tuple(got.shape) == (4, C)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    with pytest.raises(KeyError, match="no dense head"):
        class_presence({"wh": torch.from_numpy(out)})


def test_reconstruct_dropped_matches_reference():
    dec = np.random.RandomState(7).rand(4, 16, 16, 3).astype(np.float32)
    keep = np.array([1, 0, 1, 1, 0, 0, 1, 0], bool)
    want = np.asarray(jpol.reconstruct_dropped(jnp.asarray(dec), keep))
    got = reconstruct_dropped(torch.from_numpy(dec), keep)
    np.testing.assert_array_equal(got.numpy(), want)


def test_frame_diff_feature_matches_reference(scene):
    chunk = scene.frames[:10]
    want = np.asarray(jpol.frame_diff_feature(jnp.asarray(chunk)))
    got = frame_diff_feature(torch.from_numpy(chunk)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_all_baselines_run(port_models):
    """``tests/test_system.py::test_all_baselines_run`` on the port at
    96x160 (random-init weights instead of trained ones): every baseline
    gives a well-formed summary, and DDS pays its extra round trip."""
    dnn, cam, _ = port_models
    frames = make_scene("dashcam", seed=42, T=10, H=H, W=W).frames
    refs = make_reference(frames, dnn, qp_hi=30)
    runs = [
        tb.run_uniform(frames, dnn, 38, refs=refs, device="cpu"),
        tb.run_dds(frames, dnn, refs=refs, device="cpu"),
        tb.run_eaar(frames, dnn, refs=refs, device="cpu"),
        tb.run_reducto(frames, dnn, refs=refs, device="cpu"),
        tb.run_vigil(frames, dnn, cam, refs=refs, device="cpu"),
    ]
    for r in runs:
        s = r.summary()
        assert 0.0 <= s["accuracy"] <= 1.0, s
        assert s["delay_s"] > 0 and s["bytes_per_chunk"] > 0, s
    assert runs[1].summary()["extra_rtt_s"] > 0
