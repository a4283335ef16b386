"""Windowed aggregation of the port against the reference on the CPU:
``core/aggregate.py`` (a numpy copy, held bit for bit), the per-lane
accuracy reduce (``vision.dnn.device_lane_accuracy``,
``serve.steps.make_accuracy_reduce_step``) and the fleet engine under
``detail="windowed"`` (``run`` and ``serve_loop``).

Tolerances, each with its reason:
- ``FleetAggregator``, ``AggregateResult`` (``merge``, ``relabel``, wire
  form, ``export_state`` / ``import_state``), ``P2Quantile`` and
  ``ReservoirSample``: bit-equal, the same float64 numpy and the same
  seeded RNG on the same observations;
- ``device_lane_accuracy``: within 1e-6 of the reference's, both float32
  on the same outputs;
- the windowed engine on a segmentation fleet: served stream-chunks,
  stream ids, intervals and tier counts equal; the accuracy sum within
  1e-6 per stream-chunk; bytes and delay sums within rtol 1e-3 (the
  fleet's bounds in ``tests/test_torch_fleet.py``).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.control import autoscaler as jas
from repro.core import aggregate as ja
from repro.core import pipeline as jp
from repro.core.quality import QualityConfig as JQualityConfig
from repro.data.video import make_scene
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import MultiStreamEngine as JMultiStreamEngine
from repro.vision import dnn as jv
from repro_torch.control import ChurnEvent
from repro_torch.core import aggregate as ta
from repro_torch.core.pipeline import NetworkConfig, make_reference
from repro_torch.core.quality import QualityConfig
from repro_torch.engine import EngineConfig, MultiStreamEngine
from repro_torch.serve import steps as tsteps
from repro_torch.vision import dnn as tv
from repro_torch.weights import final_dnn_from_numpy
from test_torch_fleet import QCFG, SEEDS, W, H, _np_tree, port_models, \
    ref_models, weights

T = 30
ACC_ATOL, REL = 1e-6, 1e-3


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


def _schedule(seed, n_cis, n_streams):
    """Per interval a random active subset of the stream ids with random
    per-lane scalars; some intervals are all-quiet (skipped, like the
    engine's). Delays straddle the default SLO tiers."""
    rng = np.random.RandomState(seed)
    names = [t.name for t in ja.DEFAULT_TIERS]
    tier_of = {sid: names[rng.randint(len(names))]
               for sid in range(n_streams)}
    batches = []
    for ci in range(n_cis):
        a = rng.randint(0, n_streams + 1)
        if a:
            batches.append((ci, rng.choice(n_streams, size=a, replace=False),
                            rng.rand(a), rng.rand(a) * 1e4,
                            rng.rand(a) * 2.0))
    return tier_of, batches


def _observe(mod, tier_of, batches, **kw):
    agg = mod.AggregateConfig(tier_of=tier_of, **kw).build()
    for b in batches:
        agg.observe(*b)
    return agg


def _wire(x):
    return json.dumps(x, sort_keys=True)


CASES = [  # seed, intervals, streams, window, reservoir (small: overflow)
    (0, 12, 5, 4, 2048), (1, 40, 12, 3, 16), (2, 25, 8, 1, 2048),
    (3, 60, 20, 8, 32), (4, 9, 3, 2, 4),
]


@pytest.mark.parametrize("seed,n_cis,n_streams,window,res", CASES)
def test_aggregator_is_bitwise_the_reference(seed, n_cis, n_streams, window,
                                             res):
    tier_of, batches = _schedule(seed, n_cis, n_streams)
    kw = dict(window=window, reservoir=res, n_windows=5, seed=seed)
    got = _observe(ta, tier_of, batches, **kw)
    want = _observe(ja, tier_of, batches, **kw)
    assert _wire(got.export_state()) == _wire(want.export_state())
    got_r, want_r = got.result(), want.result()
    assert _wire(got_r.to_wire()) == _wire(want_r.to_wire())
    # json compares NaN (an empty tier) equal to NaN
    assert _wire(got_r.summary()) == _wire(want_r.summary())
    assert _wire(got_r.attainment()) == _wire(want_r.attainment())
    assert _wire([got_r.delay_percentile(q) for q in (50, 90, 99)]
                 + [got_r.p90_delay_p2]) == \
        _wire([want_r.delay_percentile(q) for q in (50, 90, 99)]
              + [want_r.p90_delay_p2])


@pytest.mark.parametrize("seed,n_cis,n_streams,window,res", CASES[:3])
def test_export_import_state_resumes_as_the_reference(seed, n_cis,
                                                      n_streams, window,
                                                      res):
    """Suspended after half the schedule and resumed from the exported
    state (through JSON), in either package, the result is the
    uninterrupted reference's."""
    tier_of, batches = _schedule(seed, n_cis, n_streams)
    kw = dict(window=window, reservoir=res, seed=seed)
    half = len(batches) // 2
    first = _observe(ja, tier_of, batches[:half], **kw)
    state = json.loads(json.dumps(first.export_state()))
    resumed = ta.AggregateConfig(tier_of=tier_of, **kw).build() \
        .import_state(state)
    for b in batches[half:]:
        resumed.observe(*b)
    want = _observe(ja, tier_of, batches, **kw).result()
    assert _wire(resumed.result().to_wire()) == _wire(want.to_wire())


@pytest.mark.parametrize("n_hosts", [2, 3])
def test_merge_relabel_and_wire_match_reference(n_hosts):
    tier_of, batches = _schedule(7, 24, 12)
    parts = {}
    for mod in (ta, ja):
        parts[mod] = []
        for h in range(n_hosts):
            mine = []
            for ci, sids, accs, nbytes, delays in batches:
                m = sids % n_hosts == h
                if m.any():
                    mine.append((ci, sids[m], accs[m], nbytes[m],
                                 delays[m]))
            parts[mod].append(_observe(mod, tier_of, mine).result())
    # each port part crosses the wire into the reference and back
    crossed = [ta.AggregateResult.from_wire(json.loads(json.dumps(
        ja.AggregateResult.from_wire(p.to_wire()).to_wire())))
        for p in parts[ta]]
    got = ta.AggregateResult.merge(crossed)
    want = ja.AggregateResult.merge(parts[ja])
    assert _wire(got.to_wire()) == _wire(want.to_wire())
    assert _wire(got.summary()) == _wire(want.summary())
    mapping = {sid: sid + 100 for sid in got.stream_ids}
    assert _wire(got.relabel(mapping).to_wire()) == \
        _wire(want.relabel(mapping).to_wire())
    with pytest.raises(ValueError, match="two merged aggregates"):
        ta.AggregateResult.merge([got, got])


@pytest.mark.parametrize("q", [0.5, 0.9, 0.99])
def test_sketches_are_bitwise_the_reference(q):
    xs = np.random.RandomState(int(q * 100)).lognormal(size=500)
    got, want = ta.P2Quantile(q), ja.P2Quantile(q)
    got.extend(xs)
    want.extend(xs)
    assert got.state() == want.state() and got.value == want.value
    got_r, want_r = ta.ReservoirSample(64, seed=3), \
        ja.ReservoirSample(64, seed=3)
    for chunk in np.array_split(xs, 7):
        got_r.extend(chunk)
        want_r.extend(chunk)
    assert _wire(got_r.state()) == _wire(want_r.state())
    assert got_r.percentile(q * 100) == want_r.percentile(q * 100)
    assert ta.P2Quantile.merged_value([got.state()] * 2, q) == \
        ja.P2Quantile.merged_value([want.state()] * 2, q)


def test_aggregate_config_validation_is_loud():
    with pytest.raises(ValueError, match="unknown tier"):
        ta.AggregateConfig(tier_of={0: "platinum"}).build()
    with pytest.raises(ValueError, match="window"):
        ta.AggregateConfig(window=0).build()
    with pytest.raises(ValueError, match="positive SLO"):
        ta.SLOTier("bad", slo_s=0.0)
    with pytest.raises(ValueError, match="equally sized"):
        ta.AggregateConfig().build().observe(0, [0, 1], np.ones(1),
                                             np.ones(2), np.ones(2))


# ---------------------------------------------------------------------------
# the per-lane accuracy reduce
# ---------------------------------------------------------------------------
def _lane_trees(task, seed, n=3, t=4, hs=6, ws=10):
    rng = np.random.RandomState(seed)
    c = {"segmentation": 2, "keypoint": 5}[task]
    key = {"segmentation": "seg", "keypoint": "kp"}[task]
    a = rng.randn(n, t, hs, ws, c).astype(np.float32)
    b = a + rng.randn(*a.shape).astype(np.float32) * 0.7
    b[0] = a[0]  # a lane that agrees everywhere
    if task == "segmentation":
        b[1, ..., 0] = b[1, ..., 1] + 1.0  # a lane of one class only
    return {key: a}, {key: b}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("task", ["segmentation", "keypoint"])
def test_device_lane_accuracy_matches_reference(task, seed):
    out, ref = _lane_trees(task, seed)
    want = np.asarray(jv.device_lane_accuracy(
        task, {k: jnp.asarray(v) for k, v in out.items()},
        {k: jnp.asarray(v) for k, v in ref.items()}))
    got = tv.device_lane_accuracy(
        task, {k: torch.from_numpy(v) for k, v in out.items()},
        {k: torch.from_numpy(v) for k, v in ref.items()})
    assert got.dtype == torch.float32 and tuple(got.shape) == (3,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # and within float32 rounding of the float64 host scorer
    host = {"segmentation": tv.segmentation_iou_batched,
            "keypoint": tv.keypoint_accuracy_batched}[task](out, ref)
    np.testing.assert_allclose(got.numpy(), host, atol=1e-6, rtol=0)
    assert float(got[0]) == 1.0


def test_device_lane_accuracy_refuses_detection(port_models):
    out = {"heat": torch.zeros(1, 1, 2, 2, 1)}
    with pytest.raises(ValueError, match="detection"):
        tv.device_lane_accuracy("detection", out, out)
    with pytest.raises(ValueError, match="detection"):
        jv.device_lane_accuracy("detection", {"heat": jnp.zeros(1)},
                                {"heat": jnp.zeros(1)})
    assert not port_models[0].supports_device_accuracy
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        tsteps.make_accuracy_reduce_step(port_models[0], mesh=object())


# ---------------------------------------------------------------------------
# the windowed engine on a segmentation fleet
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def seg_weights():
    return _np_tree(jv.init_net("segmentation", jax.random.PRNGKey(5), 8))


@pytest.fixture(scope="module")
def seg_fleet():
    return np.stack([make_scene("dashcam", seed=s, T=T, H=H, W=W).frames
                     for s in SEEDS])


def test_reduce_step_matches_reference_on_server_outputs(seg_weights,
                                                        seg_fleet):
    from repro.serve import steps as jsteps

    chunk = seg_fleet[:, :10]
    want_dnn = jv.FinalDNN("segmentation", jax.tree_util.tree_map(
        jnp.asarray, seg_weights))
    got_dnn = final_dnn_from_numpy("segmentation", seg_weights,
                                   device="cpu")
    assert got_dnn.supports_device_accuracy
    srv_j = jsteps.make_server_fleet_step(want_dnn)
    srv_t = tsteps.make_server_fleet_step(got_dnn)
    noisy = np.clip(chunk + 0.05 * np.random.RandomState(0).randn(
        *chunk.shape).astype(np.float32), 0, 1)
    want = np.asarray(jsteps.make_accuracy_reduce_step(want_dnn)(
        srv_j(jnp.asarray(noisy)), srv_j(jnp.asarray(chunk))))
    got = tsteps.make_accuracy_reduce_step(got_dnn)(
        srv_t(torch.from_numpy(noisy)), srv_t(torch.from_numpy(chunk)))
    np.testing.assert_allclose(got.numpy(), want, atol=ACC_ATOL, rtol=0)
    assert 0.0 < float(got.min()) < 1.0


def _windowed(mode, engine_cls, cfg_cls, qcfg_cls, dnn, am, frames, refs,
              events, **extra):
    eng = engine_cls(dnn, am, config=cfg_cls(
        qcfg=qcfg_cls(**QCFG), impl="fast", detail="windowed",
        sim_encode_s=0.05, aggregate=(ja if engine_cls is JMultiStreamEngine
                                      else ta).AggregateConfig(window=2),
        **extra), **({} if engine_cls is JMultiStreamEngine
                     else {"device": "cpu"}))
    if mode == "run":
        return eng.run(frames, refs=refs)
    return eng.serve_loop(frames, events=events, initial=(0, 1), refs=refs,
                          rescale=False)


@pytest.mark.parametrize("reduce", ["device", "host"])
@pytest.mark.parametrize("mode", ["run", "serve_loop"])
def test_windowed_engine_matches_reference(mode, reduce, seg_weights,
                                           seg_fleet, weights):
    """Windowed accounting end to end: with refs=None the segmentation
    fleet reduces accuracy on the device; with precomputed references it
    scores on the host. Either way the aggregate is the reference's."""
    acc = weights[1]
    want_dnn = jv.FinalDNN("segmentation", jax.tree_util.tree_map(
        jnp.asarray, seg_weights))
    from repro.core.accmodel import AccModel as JAccModel
    from repro_torch.weights import accmodel_from_numpy

    want_am = JAccModel(jax.tree_util.tree_map(jnp.asarray, acc))
    got_dnn = final_dnn_from_numpy("segmentation", seg_weights,
                                   device="cpu")
    got_am = accmodel_from_numpy(acc, device="cpu")
    if reduce == "host":
        refs_j = [jp.make_reference(f, want_dnn, qp_hi=30)
                  for f in seg_fleet]
        refs_t = [make_reference(f, got_dnn, qp_hi=30) for f in seg_fleet]
    else:
        refs_j = refs_t = None
    net = dict(net=jp.NetworkConfig.shared(2.5e6, 3))
    want = _windowed(mode, JMultiStreamEngine, JEngineConfig,
                     JQualityConfig, want_dnn, want_am, seg_fleet, refs_j,
                     [jas.ChurnEvent(1, join=(2,), leave=(0,)),
                      jas.ChurnEvent(2, join=(0,))], **net)
    net = dict(net=NetworkConfig.shared(2.5e6, 3))
    got = _windowed(mode, MultiStreamEngine, EngineConfig, QualityConfig,
                    got_dnn, got_am, seg_fleet, refs_t,
                    [ChurnEvent(1, join=(2,), leave=(0,)),
                     ChurnEvent(2, join=(0,))], **net)
    assert got.streams == [] and want.streams == []
    g, w = got.aggregate, want.aggregate
    assert (g.n, g.stream_ids, g.cis) == (w.n, w.stream_ids, w.cis)
    assert g.sum_acc == pytest.approx(w.sum_acc, abs=ACC_ATOL * w.n)
    assert g.sum_bytes == pytest.approx(w.sum_bytes, rel=REL)
    assert g.sum_delay == pytest.approx(w.sum_delay, rel=REL)
    assert np.array_equal(g.attained, w.attained)
    assert np.array_equal(g.total, w.total)
    assert [x.wi for x in g.windows] == [x.wi for x in w.windows]
    for gw, ww in zip(g.windows, w.windows):
        assert gw.n == ww.n
        assert gw.sum_acc == pytest.approx(ww.sum_acc, abs=ACC_ATOL * ww.n)
        assert gw.sum_bytes == pytest.approx(ww.sum_bytes, rel=REL)
    assert got.stream_ids == want.stream_ids
    assert set(got.summary()) == set(want.summary())
    assert got.accuracy == pytest.approx(want.accuracy, abs=ACC_ATOL)
    assert got.n_streams == want.n_streams == 3
