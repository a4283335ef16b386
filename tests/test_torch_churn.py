"""Closed-loop fleet serving of the port (``MultiStreamEngine.serve_loop``,
``apply_scale``, ``control/autoscaler.py``, ``control/workload.py``)
against the reference on the CPU, and the reference's own churn
properties (``tests/test_churn.py``) held on the port.

Tolerances, each with its reason:
- ``make_workload``, ``FleetAutoscaler.decide`` / ``admit``,
  ``apply_churn``, ``pad_streams``: equal, the same numpy on the same
  inputs;
- ``serve_loop`` against the reference's on one churn schedule, per stream
  and chunk: accuracy within 1e-6, bytes, stream_s and queue_s within rtol
  1e-3 (``tests/test_torch_fleet.py``'s bounds for ``run``), the
  controller's knob path equal. The port's ``fast`` is held against the
  reference's ``fast``, its ``fused_exact`` against the reference's
  ``exact``: off the TPU the reference's ``fused_exact`` lowers to its
  ``fast_exact``, which drifts from ``exact`` (ROADMAP queue 3).

The parity schedule uses ``tests/test_torch_fleet.py``'s weights (heads
scaled so detections are sparse and well separated) and its seeds 41, 43
and 44 at 40 frames; the controller runs on a constant trace with a fixed
``sim_encode_s`` and ``rescale=False``, so both knob paths are
deterministic, and both engines overlap at depth 2 (the controller's
feedback lags by the depth). ``test_churn_schedule_is_well_posed`` holds
every chunk's delay away from the controller's thresholds, so the two
knob paths cannot part over a rounding.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.control import autoscaler as jas
from repro.control import workload as jwl
from repro.control.controller import RateController as JRateController
from repro.control.traces import constant_trace as j_constant_trace
from repro.core import pipeline as jp
from repro.data.video import make_scene
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import MultiStreamEngine as JMultiStreamEngine
from repro_torch import control as tctl
from repro_torch.control import (ChurnEvent, FleetAutoscaler, RateController,
                                 ScaleDecision, apply_churn, constant_trace,
                                 make_workload, pad_streams)
from repro_torch.control import autoscaler as tas
from repro_torch.core import pipeline as tp
from repro_torch.core.accmodel import AccModel
from repro_torch.core.pipeline import NetworkConfig, make_reference
from repro_torch.core.quality import QualityConfig
from repro_torch.engine import EngineConfig, MultiStreamEngine
from repro_torch.obs import CompileCounter
from repro_torch.vision.dnn import FinalDNN
from test_torch_fleet import (QCFG, SEEDS, W, H, port_models, ref_models,
                              weights)

T = 40
ACC_ATOL, REL = 1e-6, 1e-3
# the parity schedule: 1 -> 3 (padded 4) -> 2 -> 2 active streams
EVENTS = ((1, (1, 2), ()), (2, (), (0,)), (3, (0,), (2,)))
TRACE_BPS, RTT, SIM_ENCODE_S, BUDGET = 4e5, 0.02, 0.05, 0.5
# the reference's properties run at its own size with width-8 port models
PH, PW, PT = 64, 112, 40


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


def _events(mod):
    return [mod.ChurnEvent(c, join=j, leave=lv) for c, j, lv in EVENTS]


@pytest.fixture(scope="module")
def fleet():
    return np.stack([make_scene("dashcam", seed=s, T=T, H=H, W=W).frames
                     for s in SEEDS])


# ---------------------------------------------------------------------------
# workloads, admission and scaling decisions (numpy, equal)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(n_chunks=6, rate_per_chunk=1.5, seed=0),
    dict(n_chunks=12, rate_per_chunk=3.0, seed=7, max_concurrent=8,
         max_streams=12),
    dict(n_chunks=20, rate_per_chunk=2.0, seed=3, diurnal_amplitude=0.6,
         initial_streams=4, pareto_alpha=2.5),
    dict(n_chunks=8, rate_per_chunk=5.0, seed=11, max_concurrent=3,
         initial_streams=6),
])
def test_make_workload_matches_reference(kw):
    got, want = make_workload(**kw), jwl.make_workload(**kw)
    assert got.initial == want.initial
    assert [dataclasses.astuple(e) for e in got.events] == \
        [dataclasses.astuple(e) for e in want.events]
    assert [dataclasses.astuple(t) for t in got.tiers] == \
        [dataclasses.astuple(t) for t in want.tiers]
    assert got.tier_of == want.tier_of
    assert (got.n_blocked, got.n_streams, got.n_chunks) == \
        (want.n_blocked, want.n_streams, want.n_chunks)
    assert got.concurrency() == want.concurrency()
    assert got.tier_fractions() == want.tier_fractions()
    cfg_t, cfg_j = got.aggregate_config(window=2), \
        want.aggregate_config(window=2)
    assert cfg_t.tier_of == cfg_j.tier_of and cfg_t.window == cfg_j.window


def _timings(mod, seed, n=24):
    """Synthetic interval windows spanning idle, camera-, server- and
    host-bound fleets, and one with no timing yet."""
    rng = np.random.RandomState(seed)
    out = [mod.FleetTiming(wall_s=0.0)]
    for _ in range(n):
        wall = float(rng.uniform(0.01, 0.2))
        share = rng.dirichlet(np.ones(3)) * rng.uniform(0.05, 1.6)
        out.append(mod.FleetTiming(
            camera_s=[float(share[0] * wall)],
            server_s=[float(share[1] * wall)],
            host_s=[float(share[2] * wall / 2)] * 2, wall_s=wall))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_devices", [1, 4])
def test_autoscaler_decide_matches_reference(seed, n_devices):
    """The same decision sequence for the same synthetic timings, each
    decision fed back as the next state, as ``serve_loop`` does."""
    kw = dict(target_occupancy=0.6, idle_fraction=0.3, max_depth=3)
    got_s, want_s = FleetAutoscaler(**kw), jas.FleetAutoscaler(**kw)
    width, depth = 1, 2
    for tg, tj in zip(_timings(tp, seed), _timings(jp, seed)):
        n = int(np.random.RandomState(seed + depth).randint(1, 9))
        d_t = got_s.decide(tg, n, mesh_width=width, batch_depth=depth,
                           n_devices=n_devices)
        d_j = want_s.decide(tj, n, mesh_width=width, batch_depth=depth,
                            n_devices=n_devices)
        # tenant_share stays None on a fleet of no tenants
        assert dataclasses.astuple(d_t) == dataclasses.astuple(d_j)
        assert d_t.tenant_share is d_j.tenant_share is None
        # with per-tenant occupancies, the reference's capacity split
        counts = [n - n // 3, n // 3, 0]
        assert got_s.decide(tg, n, mesh_width=width, batch_depth=depth,
                            n_devices=n_devices,
                            tenant_streams=counts).tenant_share == \
            want_s.decide(tj, n, mesh_width=width, batch_depth=depth,
                          n_devices=n_devices,
                          tenant_streams=counts).tenant_share
        assert tas.stage_occupancy(tg) == jas.stage_occupancy(tj)
        width, depth = d_t.mesh_width, d_t.batch_depth
    if n_devices == 1:  # one card: never a wider mesh
        assert width == 1


def test_autoscaler_counts_one_card_until_module_8():
    """The port's default device count is the one card its engine uses:
    a camera-bound fleet holds its width instead of widening."""
    busy = tp.FleetTiming(camera_s=[0.9], server_s=[0.0], host_s=[0.0],
                          wall_s=1.0)
    d = FleetAutoscaler().decide(busy, 8, mesh_width=1, batch_depth=2)
    assert (d.mesh_width, d.batch_depth, d.reason) == (1, 2, "steady")
    assert FleetAutoscaler().decide(busy, 8, n_devices=4).mesh_width == 2


@pytest.mark.parametrize("pad_pow2,slack,width", [
    (True, 2.0, 1), (False, 2.0, 1), (True, 1.0, 1), (True, 2.0, 2),
])
def test_autoscaler_admit_matches_reference(pad_pow2, slack, width):
    counts = [1, 3, 2, 8, 5, 0, 4, 7, 1, 16, 9, 2, 0, 6]
    got_s = FleetAutoscaler(pad_pow2=pad_pow2, reuse_slack=slack)
    want_s = jas.FleetAutoscaler(pad_pow2=pad_pow2, reuse_slack=slack)
    for n in counts:
        got, want = got_s.admit(n, mesh_width=width), \
            want_s.admit(n, mesh_width=width)
        assert (got.n_active, got.n_padded, got.reused) == \
            (want.n_active, want.n_padded, want.reused)
        assert np.array_equal(got.active, want.active)
    assert got_s.compiled_shapes == want_s.compiled_shapes
    with pytest.raises(ValueError):
        got_s.admit(-1)


def test_churn_vocabulary_and_padding_match_reference():
    events_t = [ChurnEvent(1, join=(2,)), ChurnEvent(2, leave=(0, 2))]
    events_j = [jas.ChurnEvent(1, join=(2,)), jas.ChurnEvent(2, leave=(0, 2))]
    for active, ci in (([0, 1], 0), ([0, 1], 1), ([0, 1, 2], 2)):
        assert apply_churn(active, events_t, ci) == \
            jas.apply_churn(active, events_j, ci)
    with pytest.raises(ValueError):  # leaving without being active
        apply_churn([1], events_t, 2)
    with pytest.raises(ValueError):  # joining twice
        apply_churn([2], events_t, 1)
    with pytest.raises(ValueError):
        ChurnEvent(0, join=(1,), leave=(1,))
    with pytest.raises(ValueError):
        ChurnEvent(-1)
    x = np.arange(3 * 2 * 4, dtype=np.float32).reshape(3, 2, 4)
    assert np.array_equal(pad_streams(x, 5), jas.pad_streams(x, 5))
    assert pad_streams(x, 3) is x
    assert torch.equal(pad_streams(torch.from_numpy(x), 5),
                       torch.from_numpy(jas.pad_streams(x, 5)))
    with pytest.raises(ValueError):
        pad_streams(x, 2)
    assert ScaleDecision(1, 1, "x").overlap is False


# ---------------------------------------------------------------------------
# serve_loop against the reference
# ---------------------------------------------------------------------------
def _serve(engine_cls, config_cls, models, mods, impl, frames, refs):
    trace_fn, ctrl_cls, qcfg_cls, events = mods
    ctrl = ctrl_cls(delay_budget_s=BUDGET)
    eng = engine_cls(*models, config=config_cls(
        qcfg=qcfg_cls(**QCFG), impl=impl,
        trace=trace_fn(TRACE_BPS, rtt_s=RTT), controller=ctrl,
        sim_encode_s=SIM_ENCODE_S), **(
            {"device": "cpu"} if engine_cls is MultiStreamEngine else {}))
    res = eng.serve_loop(frames, events=events, initial=(0,), refs=refs,
                         rescale=False)
    return res, ctrl


@pytest.fixture(scope="module")
def ref_serves(ref_models, fleet):
    from repro.core.quality import QualityConfig as JQualityConfig

    dnn = ref_models[0]
    refs = [jp.make_reference(f, dnn, qp_hi=30) for f in fleet]
    mods = (j_constant_trace, JRateController, JQualityConfig,
            _events(jas))
    return {impl: _serve(JMultiStreamEngine, JEngineConfig, ref_models,
                         mods, impl, fleet, refs)
            for impl in ("fast", "exact")}


@pytest.fixture(scope="module")
def port_refs(port_models, fleet):
    return [make_reference(f, port_models[0], qp_hi=30) for f in fleet]


def test_churn_schedule_is_well_posed(ref_serves):
    """Both padded shapes run, every chunk's delay and backlog lie at
    least 1% from the controller's thresholds, and the knobs move."""
    for res, ctrl in ref_serves.values():
        assert res.shapes == [1, 4]
        budget = ctrl.delay_budget_s
        for _, obs in ctrl.history:
            for value, edge in ((obs.total_delay_s, budget),
                                (obs.total_delay_s, ctrl.headroom * budget),
                                (obs.queue_s,
                                 ctrl.backlog_tolerance * budget)):
                if value:
                    assert abs(value - edge) > 0.01 * edge
        assert len({k.qp_hi for k, _ in ctrl.history}) >= 2


@pytest.mark.parametrize("impl,ref_impl", [("fast", "fast"),
                                           ("fused_exact", "exact")])
def test_serve_loop_matches_reference(impl, ref_impl, port_models, fleet,
                                      port_refs, ref_serves):
    want, want_ctrl = ref_serves[ref_impl]
    mods = (constant_trace, RateController, QualityConfig, _events(tctl))
    got, got_ctrl = _serve(MultiStreamEngine, EngineConfig, port_models,
                           mods, impl, fleet, port_refs)
    assert got.stream_ids == want.stream_ids == [0, 1, 2]
    assert got.shapes == want.shapes
    assert got.served_cis == want.served_cis == [0, 1, 2, 3]
    for gs, ws in zip(got.streams, want.streams):
        assert gs.method == ws.method
        assert [c.ci for c in gs.chunks] == [c.ci for c in ws.chunks]
        for g, w in zip(gs.chunks, ws.chunks):
            assert g.accuracy == pytest.approx(w.accuracy, abs=ACC_ATOL)
            assert g.bytes == pytest.approx(w.bytes, rel=REL)
            assert g.stream_s == pytest.approx(w.stream_s, rel=REL)
            assert g.queue_s == pytest.approx(w.queue_s, rel=REL, abs=1e-9)
            assert g.encode_s == w.encode_s == SIM_ENCODE_S
    assert [dataclasses.astuple(k) for k, _ in got_ctrl.history] == \
        [dataclasses.astuple(k) for k, _ in want_ctrl.history]
    assert set(got.summary()) == set(want.summary())
    assert got.decisions == [] and want.decisions == []


# ---------------------------------------------------------------------------
# the reference's churn properties (tests/test_churn.py) on the port
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    g = torch.Generator().manual_seed(0)
    return (FinalDNN("detection", width=8, generator=g, device="cpu"),
            AccModel(width=8, generator=g, device="cpu"))


@pytest.fixture(scope="module")
def small_fleet():
    return np.stack([make_scene("dashcam", seed=20 + i, T=PT, H=PH,
                                W=PW).frames for i in range(4)])


def _engine(models, **kw):
    return MultiStreamEngine(*models, config=EngineConfig(impl="fast", **kw),
                             device="cpu")


def _by_stream(res):
    return dict(zip(res.stream_ids, res.streams))


@pytest.mark.parametrize("net", ["shared", "per_stream"])
def test_padded_lanes_contribute_exactly_zero(net, models, small_fleet):
    """3 streams on a padded 4-lane shape against the same 3 unpadded:
    per-chunk accuracy, bytes and delays agree and no fourth stream
    appears. With a per-stream NetworkConfig (no uplink_bps) padded lanes
    must not count as cameras and grant phantom uplink."""
    net = NetworkConfig.shared(2.5e6, 3) if net == "shared" \
        else NetworkConfig(bandwidth_bps=1e6)
    runs = {}
    for pad_pow2 in (True, False):
        eng = _engine(models, net=net,
                      autoscaler=FleetAutoscaler(pad_pow2=pad_pow2))
        runs[pad_pow2] = eng.serve_loop(small_fleet[:3], rescale=False)
        assert eng.autoscaler.compiled_shapes == ((4,) if pad_pow2
                                                  else (3,))
    padded, unpadded = runs[True], runs[False]
    assert padded.stream_ids == unpadded.stream_ids == [0, 1, 2]
    for rp, ru in zip(padded.streams, unpadded.streams):
        assert len(rp.chunks) == len(ru.chunks) == PT // 10
        for cp, cu in zip(rp.chunks, ru.chunks):
            assert cp.accuracy == pytest.approx(cu.accuracy, abs=1e-6)
            assert cp.bytes == pytest.approx(cu.bytes, rel=1e-6)
            assert cp.bytes > 0
            assert cp.stream_s == pytest.approx(cu.stream_s, rel=1e-6)
            assert cp.queue_s == cu.queue_s == 0.0
    assert padded.accuracy == pytest.approx(unpadded.accuracy, abs=1e-6)


def test_serve_loop_validates_initial_events_and_unported_arguments(
        models):
    eng = MultiStreamEngine(None, None, device="cpu")
    frames = np.zeros((2, 10, 16, 16, 3), np.float32)
    with pytest.raises(ValueError):  # duplicate: would double-serve
        eng.serve_loop(frames, initial=(0, 0))
    with pytest.raises(ValueError):  # out of range
        eng.serve_loop(frames, initial=(2,))
    with pytest.raises(ValueError):  # negative
        eng.serve_loop(frames, initial=(-1,))
    with pytest.raises(ValueError):  # an event past the schedule
        eng.serve_loop(frames, events=[ChurnEvent(1, join=(1,))],
                       initial=(0,))
    for kw in (dict(owned=(0, 1)), dict(start_chunk=1),
               dict(stop_chunk=1), dict(state={})):
        with pytest.raises(NotImplementedError, match="module 8"):
            eng.serve_loop(frames, **kw)
    with pytest.raises(NotImplementedError, match="module 8"):
        eng.last_serve_state
    with pytest.raises(NotImplementedError, match="module 8"):
        eng.apply_scale(ScaleDecision(2, 2, "wider"))
    with pytest.raises(ValueError, match="no ScaleDecision"):
        eng.apply_scale()


def test_empty_fleet_result_reports_nan_not_crash(models, small_fleet):
    eng = _engine(models, autoscaler=FleetAutoscaler())
    res = eng.serve_loop(small_fleet[:2, :20], initial=())
    assert res.streams == [] and res.stream_ids == []
    assert res.shapes == [] and eng._warm == {}  # nothing warmed either
    assert np.isnan(res.p90_delay)
    assert np.isnan(res.summary()["p95_delay_s"])


def test_churn_builds_nothing_new_and_log_shapes(models, small_fleet):
    """1 -> 2 -> 4 -> 1 active streams with the controller's knobs moving
    every chunk warms one padded shape each (O(log N_max)), and a second
    schedule over the same shapes with another knob path builds and warms
    nothing new."""
    ctrl = RateController(delay_budget_s=0.4)
    eng = _engine(models, trace=constant_trace(1e5, rtt_s=0.02),
                  controller=ctrl, autoscaler=FleetAutoscaler())
    first = eng.serve_loop(
        small_fleet, initial=(0,),
        events=[ChurnEvent(1, join=(1,)), ChurnEvent(2, join=(2, 3)),
                ChurnEvent(3, leave=(1, 2, 3))],
        rescale=False)
    assert first.shapes == [1, 2, 4]
    counter = CompileCounter.for_engine(eng)
    counter.assert_total(steps=1, warm=len(first.shapes))
    second = eng.serve_loop(
        small_fleet, initial=(0, 1, 2, 3),
        events=[ChurnEvent(1, leave=(2, 3)), ChurnEvent(2, leave=(1,)),
                ChurnEvent(3, join=(3,))],
        rescale=False)
    counter.assert_no_recompiles("re-admission at served shapes")
    assert second.shapes == [1, 2, 4]
    assert len({k.qp_hi for k, _ in ctrl.history}) >= 2
    assert {sid: len(r.chunks) for sid, r in _by_stream(second).items()} \
        == {0: 4, 1: 2, 2: 1, 3: 2}
    assert all(c.bytes > 0 for r in second.streams for c in r.chunks)


def test_scale_decisions_apply_mid_loop_without_teardown(models,
                                                         small_fleet):
    """A ScaleDecision adopted between chunks changes scheduling only."""

    class DeepenOnce(FleetAutoscaler):
        def decide(self, timing, n_streams, mesh_width=1, batch_depth=2,
                   n_devices=None):
            return ScaleDecision(mesh_width=1, batch_depth=3,
                                 reason="forced: deepen")

    class Serialize(FleetAutoscaler):
        def decide(self, timing, n_streams, mesh_width=1, batch_depth=2,
                   n_devices=None):
            return ScaleDecision(mesh_width=1, batch_depth=1,
                                 reason="forced: serialize")

    net = NetworkConfig.shared(2.5e6, 3)
    eng = _engine(models, net=net, autoscaler=DeepenOnce())
    rescaled = eng.serve_loop(small_fleet[:3])
    assert eng.depth == 3 and eng.overlap
    assert eng.last_scale.batch_depth == 3
    assert [d.batch_depth for d in rescaled.decisions] == [3, 3, 3, 3]
    baseline = _engine(models, net=net, autoscaler=FleetAutoscaler()) \
        .serve_loop(small_fleet[:3], rescale=False)
    for rr, rb in zip(rescaled.streams, baseline.streams):
        for cr, cb in zip(rr.chunks, rb.chunks):
            assert cr.accuracy == cb.accuracy and cr.bytes == cb.bytes
    eng2 = _engine(models, net=net, autoscaler=Serialize())
    serial = eng2.serve_loop(small_fleet[:3])
    assert not eng2.overlap and eng2.depth == 1
    assert all(len(r.chunks) == PT // 10 for r in serial.streams)
    assert set(serial.summary()) >= {"n_rescales", "n_compiled_shapes"}


@pytest.mark.parametrize("every", [2, 3])
def test_decide_every_spaces_out_decisions(every, models, small_fleet):
    """``decide_every=k`` decides after intervals k-1, 2k-1, ... only (the
    reference's rule), on that interval's own window, and a decision it
    adopts changes scheduling only: results equal an undecided run."""

    class Record(FleetAutoscaler):
        def decide(self, timing, n_streams, mesh_width=1, batch_depth=2,
                   n_devices=None):
            seen.append((len(timing.camera_s), n_streams, batch_depth))
            return ScaleDecision(mesh_width=1, batch_depth=3,
                                 reason="forced: deepen")

    seen = []
    net = NetworkConfig.shared(2.5e6, 3)
    eng = _engine(models, net=net, autoscaler=Record())
    res = eng.serve_loop(small_fleet[:3], decide_every=every)
    n_int = PT // 10
    assert len(res.decisions) == len(seen) == n_int // every
    assert seen == [(1, 4, 2)] + [(1, 4, 3)] * (n_int // every - 1)
    assert eng.depth == 3 and eng.last_scale is res.decisions[-1]
    baseline = _engine(models, net=net, autoscaler=FleetAutoscaler()) \
        .serve_loop(small_fleet[:3], rescale=False)
    for rr, rb in zip(res.streams, baseline.streams):
        assert [(c.accuracy, c.bytes) for c in rr.chunks] == \
            [(c.accuracy, c.bytes) for c in rb.chunks]


def test_all_quiet_interval_idles_and_resumes(models, small_fleet):
    """Everyone leaves for one interval: nothing runs, the uplink clock's
    backlog survives the lull, and the lull relieves the queue against
    serving straight through."""
    trace = constant_trace(3e4, rtt_s=0.02)  # a saturated uplink
    res = _engine(models, trace=trace, autoscaler=FleetAutoscaler()) \
        .serve_loop(small_fleet[:2], initial=(0, 1),
                    events=[ChurnEvent(2, leave=(0, 1)),
                            ChurnEvent(3, join=(0, 1))])
    by_stream = _by_stream(res)
    assert {sid: len(r.chunks) for sid, r in by_stream.items()} == \
        {0: 3, 1: 3}
    assert len(res.timing.camera_s) == 3 and res.served_cis == [0, 1, 3]
    pre_lull, post_lull = by_stream[0].chunks[1], by_stream[0].chunks[2]
    assert pre_lull.queue_s > 0.0
    assert post_lull.queue_s > pre_lull.queue_s
    straight = _engine(models, trace=trace,
                       autoscaler=FleetAutoscaler()).serve_loop(
        small_fleet[:2])
    assert post_lull.queue_s < _by_stream(straight)[0].chunks[3].queue_s
    assert res.shapes == [2]


def test_run_with_autoscaler_and_apply_scale(models, small_fleet):
    """``run`` leaves its decision in ``last_scale``; ``apply_scale``
    adopts depth and overlap for the next run."""
    eng = _engine(models, autoscaler=FleetAutoscaler())
    eng.run(small_fleet[:2, :20])
    assert eng.last_scale is not None and eng.last_scale.mesh_width == 1
    eng.apply_scale(ScaleDecision(1, 1, "serialize"))
    assert (eng.overlap, eng.depth) == (False, 1)
    eng.apply_scale(ScaleDecision(1, 3, "deepen"))
    assert (eng.overlap, eng.depth) == (True, 3)
