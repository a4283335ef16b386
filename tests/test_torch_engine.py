"""The slice as a whole: the port's ``StreamingEngine.run(AccMPEGPolicy)``
against the reference engine with ``impl="exact"`` on the CPU, with the
reference's weights carried across.

Per chunk, bytes agree within rtol 1e-3 and accuracy within 1e-6; timing
fields are excluded. Random-init weights give flat outputs (every heat
near 0.5), where float order alone would reorder detections, so the
heads' last layers are scaled to spread their logits and the heat bias is
lowered so that peaks are sparse; the same weights go to both packages.
The seed is kept only if no detection score, NMS comparison, IoU or
AccModel score lies within 1e-5 of its threshold, so that no decision
can flip on float order (``test_seed_is_well_posed``
checks it). A round-half flip in the codec, which two float orders
produce about once in a few chunks at this size, would also move the
accuracy: ``test_make_reference_matches`` shows the seed's D(H) is free
of one (seeds 36, 37 and 40 are not). The verify recipe's scene seed 33
has an NMS comparison 1.9e-6 from its slack; 34, the next seed, passes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.codec.codec import encode_chunk
from repro.core import accmodel as jam
from repro.core.pipeline import make_reference as j_make_reference
from repro.core.quality import QualityConfig as JQualityConfig
from repro.core.quality import qp_map_from_scores
from repro.data.video import make_scene
from repro.engine import AccMPEGPolicy as JAccMPEGPolicy
from repro.engine import StreamingEngine as JStreamingEngine
from repro.engine import UniformPolicy as JUniformPolicy
from repro.vision import dnn as jv
from repro_torch.core.pipeline import make_reference, run_accmpeg
from repro_torch.core.quality import QualityConfig
from repro_torch.data.video import make_scene as t_make_scene
from repro_torch.engine import AccMPEGPolicy, StreamingEngine, UniformPolicy
from repro_torch.weights import accmodel_from_numpy, final_dnn_from_numpy

H, W, T, WIDTH = 96, 160, 20, 8
SEED = 34
ALPHA, GAMMA, QP_LO = 0.7, 1, 46
QCFG = dict(alpha=ALPHA, gamma=GAMMA, qp_lo=QP_LO)
BYTES_RTOL, ACC_ATOL, MARGIN = 1e-3, 1e-6, 1e-5


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
def scene():
    return make_scene("dashcam", seed=SEED, T=T, H=H, W=W)


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
def ref_run(ref_models, scene):
    dnn, am = ref_models
    refs = j_make_reference(scene.frames, dnn, qp_hi=30)
    run = JStreamingEngine(dnn).run(
        JAccMPEGPolicy(am, JQualityConfig(**QCFG)),
        scene.frames, refs=refs)
    return refs, run


def _assert_chunks_match(got, want):
    assert len(got.chunks) == len(want.chunks) == T // 10
    for g, w in zip(got.chunks, want.chunks):
        assert g.accuracy == pytest.approx(w.accuracy, abs=ACC_ATOL)
        assert g.bytes == pytest.approx(w.bytes, rel=BYTES_RTOL)
        assert g.stream_s == pytest.approx(w.stream_s, rel=BYTES_RTOL)
        assert g.ci == w.ci


def test_scene_copy_is_identical():
    a = make_scene("dashcam", seed=SEED, T=4, H=H, W=W)
    b = t_make_scene("dashcam", seed=SEED, T=4, H=H, W=W)
    np.testing.assert_array_equal(a.frames, b.frames)
    np.testing.assert_array_equal(a.masks, b.masks)
    assert a.boxes == b.boxes


def test_make_reference_matches(ref_run, port_models, scene):
    refs = make_reference(scene.frames, port_models[0], qp_hi=30)
    assert len(refs) == len(ref_run[0])
    for got, want in zip(refs, ref_run[0]):
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=1e-4)


def _margins(dnn, am, frames):
    """Distance of every decision of the reference run to its threshold."""
    qcfg = JQualityConfig(**QCFG)
    out = []
    for s in range(0, T, 10):
        chunk = jnp.asarray(frames[s:s + 10])
        scores = am.scores(chunk[:1])
        out.append(float(jnp.abs(scores - ALPHA).min()))
        qmap, _ = qp_map_from_scores(scores[0], qcfg)
        dec, _ = encode_chunk(chunk, qmap[None])
        hq, _ = encode_chunk(chunk, jnp.full_like(qmap[None], 30.0))
        dets = []
        for o in (dnn.predict(dec), dnn.predict(hq)):
            heat = jax.nn.sigmoid(o["heat"])
            pooled = jax.lax.reduce_window(heat, -jnp.inf, jax.lax.max,
                                           (1, 3, 3, 1), (1, 1, 1, 1),
                                           "SAME")
            # NMS decides cells that reach the score threshold and are not
            # the window maximum (which is always kept)
            live = (heat < pooled) & (heat >= 0.3 - MARGIN)
            out.append(float(jnp.abs(heat - (pooled - 1e-6))[live].min(
                initial=1.0)))
            keep = np.asarray(jv.detection_keep_heat(o))
            out.append(float(np.abs(keep[keep > 0] - 0.3).min()))
            dets.append(jv.decode_detections(o))
        for d_frame, r_frame in zip(*dets):
            for a in d_frame:
                for b in r_frame:
                    iou = jv._iou(a, b)
                    if iou > 0:
                        out.append(abs(iou - 0.5))
    return out


def test_seed_is_well_posed(ref_models, scene, ref_run):
    """No decision of the run lies within 1e-5 of its threshold, and the
    run exercises both QP levels and non-trivial detections."""
    dnn, am = ref_models
    assert min(_margins(dnn, am, scene.frames)) > MARGIN
    share = float((am.scores(jnp.asarray(scene.frames[:1])) >= ALPHA).mean())
    assert 0.1 < share < 0.9
    n_dets = [len(d) for d in jv.decode_detections(ref_run[0][0])]
    assert 0 < np.mean(n_dets) < 50
    accs = [c.accuracy for c in ref_run[1].chunks]
    assert min(accs) < 1.0 and max(accs) > 0.0, accs


@pytest.mark.parametrize("impl", ["exact", "pallas", "fused_exact",
                                  "fast_exact"])
def test_accmpeg_run_matches_reference_exact(impl, ref_run, port_models,
                                             scene):
    """Every backend with the exact encoder's semantics reproduces the
    reference's exact run; on the CPU the kernel backends take their
    plain versions."""
    dnn, am = port_models
    refs = make_reference(scene.frames, dnn, qp_hi=30)
    got = StreamingEngine(dnn, impl=impl, device="cpu").run(
        AccMPEGPolicy(am, QualityConfig(**QCFG)),
        scene.frames, refs=refs)
    _assert_chunks_match(got, ref_run[1])
    assert got.method == ref_run[1].method
    assert set(got.summary()) == set(ref_run[1].summary())
    assert all(c.encode_s > 0 and c.overhead_s > 0 for c in got.chunks)


def test_run_accmpeg_wrapper_and_uniform_policy(ref_models, port_models,
                                                scene, ref_run):
    dnn, am = port_models
    refs = make_reference(scene.frames, dnn, qp_hi=30)
    got = run_accmpeg(scene.frames, am, dnn,
                      QualityConfig(**QCFG), refs=refs)
    _assert_chunks_match(got, ref_run[1])
    want_u = JStreamingEngine(ref_models[0]).run(
        JUniformPolicy(40), scene.frames, refs=ref_run[0])
    got_u = StreamingEngine(dnn, device="cpu").run(
        UniformPolicy(40), scene.frames, refs=refs)
    _assert_chunks_match(got_u, want_u)
    assert got_u.method == want_u.method == "uniform_qp40"


def test_policy_records_the_high_quality_masks(port_models, scene):
    dnn, am = port_models
    policy = AccMPEGPolicy(am, QualityConfig(**QCFG))
    StreamingEngine(dnn, impl="fused", device="cpu").run(
        policy, scene.frames[:10])
    assert len(policy.masks) == 1
    assert tuple(policy.masks[0].shape) == (1, H // 16, W // 16)
