"""The port's single-stream control plane against the reference, on the
CPU: bandwidth traces, their transmit-time solvers and the uplink clock
(pure numpy in both packages, so held bitwise), the AIMD rate controller
on given observations (exact), ``_controlled_prep`` (exact), and the
engine's trace mode.

Whole runs in trace mode depend on the measured camera compute, which
sets each chunk's ready time. The parity tests take it out: both
engines' clocks are stubbed to a constant (``_frozen_clocks``), so that
``encode_s`` and ``overhead_s`` are 0 and ``stream_s``, ``queue_s`` and
``extra_rtt_s`` follow the bytes alone (held within rtol 1e-3, as bytes
are). The controlled run keeps the real clock but a budget every chunk
misses by its streaming delay alone, so each decision is a decrease
whatever the compute time. Weights and the scene are
``tests/test_torch_baselines.py``'s (seed 34, whose decisions its seed
check keeps away from their thresholds); the controlled run's AccModel
scores and change features are checked here against the knobs it used.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.engine.engine as j_engine
from repro.control import ControlledAccMPEGPolicy as JControlledPolicy
from repro.control import RateController as JRateController
from repro.control import traces as jtr
from repro.control.controller import ChunkObservation as JObservation
from repro.control.controller import _controlled_prep as j_prep
from repro.core import accmodel as jam
from repro.core.pipeline import UplinkClock as JUplinkClock
from repro.core.pipeline import make_reference as j_make_reference
from repro.data.video import make_scene
from repro.engine import DDSPolicy as JDDSPolicy
from repro.engine import StreamingEngine as JStreamingEngine
from repro.engine.policies import frame_diff_feature as j_feature
from repro.vision import dnn as jv
from repro_torch.control import (ChunkObservation, ControlKnobs,
                                 ControlledAccMPEGPolicy, NetworkTrace,
                                 RateController, TRACE_GENRES, make_trace)
from repro_torch.control import traces as ttr
from repro_torch.control.controller import _controlled_prep
from repro_torch.core.pipeline import (NetworkConfig, UplinkClock,
                                       make_reference, stream_delay)
from repro_torch.engine import AccMPEGPolicy, DDSPolicy, StreamingEngine
from repro_torch.engine import engine as t_engine
from repro_torch.weights import accmodel_from_numpy, final_dnn_from_numpy
from test_torch_baselines import SEED, WIDTH, _detector, _np_tree

H, W, T = 96, 160, 40
REL = 1e-3
MARGIN = 1e-5


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


@pytest.fixture(scope="module")
def weights():
    acc = _np_tree(jam.accmodel_init(jax.random.PRNGKey(1), WIDTH))
    acc["c3"]["w"] = acc["c3"]["w"] * 500.0
    return _detector(2, 6000.0, 8000.0), acc


@pytest.fixture(scope="module")
def frames():
    return make_scene("dashcam", seed=SEED, T=T, H=H, W=W).frames


@pytest.fixture(scope="module")
def ref_models(weights):
    det, acc = (jax.tree_util.tree_map(jnp.asarray, w) for w in weights)
    return jv.FinalDNN("detection", det), jam.AccModel(acc)


@pytest.fixture(scope="module")
def port_models(weights):
    return (final_dnn_from_numpy("detection", weights[0], device="cpu"),
            accmodel_from_numpy(weights[1], device="cpu"))


@pytest.fixture
def _frozen_clocks(monkeypatch):
    frozen = types.SimpleNamespace(perf_counter=lambda: 0.0)
    monkeypatch.setattr(j_engine, "time", frozen)
    monkeypatch.setattr(t_engine, "time", frozen)


# ---------------------------------------------------------------------------
# traces, solvers, clock
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("genre", sorted(TRACE_GENRES))
def test_traces_are_bitwise_the_reference(genre):
    assert sorted(TRACE_GENRES) == sorted(jtr.TRACE_GENRES)
    for seed in range(6):
        for kw in ({}, {"duration_s": 30.0}, {"duration_s": 7.0,
                                               "dt_s": 0.1},
                   {"mean_bps": 1.5e6, "rtt_s": 0.05}):
            got = make_trace(genre, seed=seed, **kw)
            want = jtr.make_trace(genre, seed=seed, **kw)
            assert got.bw_bps.dtype == want.bw_bps.dtype == np.float64
            np.testing.assert_array_equal(got.bw_bps, want.bw_bps)
            assert (got.dt_s, got.rtt_s, got.genre, got.seed) == \
                (want.dt_s, want.rtt_s, want.genre, want.seed)
            assert got.mean_bps == want.mean_bps
            assert got.scaled_to_mean(2e6).mean_bps == \
                want.scaled_to_mean(2e6).mean_bps
    with pytest.raises(KeyError, match="unknown trace genre"):
        make_trace("starlink")


def _trace_pairs():
    """(port, reference) traces of the reference tests' cases, and a
    seeded trace of each genre."""
    pairs = [(NetworkTrace(np.array([1e6, 2e6]), dt_s=1.0, rtt_s=0.0),
              jtr.NetworkTrace(np.array([1e6, 2e6]), dt_s=1.0, rtt_s=0.0)),
             (ttr.constant_trace(7.5e5, rtt_s=0.08),
              jtr.constant_trace(7.5e5, rtt_s=0.08)),
             (NetworkTrace(np.array([1e6, 4e6]), dt_s=1.0, rtt_s=0.0),
              jtr.NetworkTrace(np.array([1e6, 4e6]), dt_s=1.0, rtt_s=0.0)),
             (NetworkTrace(np.full(1000, 1e6), dt_s=0.1, rtt_s=0.0),
              jtr.NetworkTrace(np.full(1000, 1e6), dt_s=0.1, rtt_s=0.0)),
             (NetworkTrace(np.full(50, 2e6), dt_s=0.3, rtt_s=0.0),
              jtr.NetworkTrace(np.full(50, 2e6), dt_s=0.3, rtt_s=0.0))]
    pairs += [(make_trace(g, seed=3), jtr.make_trace(g, seed=3))
              for g in sorted(TRACE_GENRES)]
    return pairs


def test_transmit_times_are_bitwise_the_reference():
    rng = np.random.RandomState(0)
    for got, want in _trace_pairs():
        cases = [(1.5e6 / 8, 0.0), (1.5e6 / 8, 1.5), (0.0, 3.3),
                 (1e6 / 8, 1.0), (1.5e5 / 8, 4.25)]
        cases += [(float(b), float(s)) for b, s in zip(
            rng.uniform(0, 4e5, 12), rng.uniform(0, 90.0, 12))]
        cases += [(1e6 / 8, float(s)) for s in np.arange(0.0, 3.0, 0.137)]
        for n_bytes, start in cases:
            assert got.transmit_time(n_bytes, start) == \
                want.transmit_time(n_bytes, start)
        for sizes, start in (([1000.0, 1000.0], 0.0), ([0.0, 1000.0], 0.0),
                             ([100.0, 900.0, 4000.0], 0.0),
                             ([2e6 / 8, 2e6 / 8], 0.0),
                             ([1e5 / 8, 1e5 / 8], 4.25),
                             (list(rng.uniform(0, 2e5, 8)), 17.3), ([], 1.0)):
            assert got.shared_transmit_times(sizes, start) == \
                want.shared_transmit_times(sizes, start)
        assert got.bandwidth_at(12.34) == want.bandwidth_at(12.34)
        assert got.duration_s == want.duration_s
    # the constant trace is the constant model
    net = NetworkConfig(bandwidth_bps=7.5e5, rtt_s=0.08)
    tr = ttr.constant_trace(net.bandwidth_bps, rtt_s=net.rtt_s)
    for b in (0.0, 123.0, 54321.0):
        assert tr.transmit_time(b) + tr.rtt_s / 2 == \
            pytest.approx(stream_delay(b, net))


def test_uplink_clock_queues_as_the_reference():
    """The reference test's saturated 1 KB/s uplink (backlog grows by
    2/3 s a chunk), then a random send sequence on an lte trace, single
    and shared: every (stream_s, queue_s) bit for bit."""
    got = UplinkClock(ttr.constant_trace(8e3, rtt_s=0.0), 10, 30.0)
    want = JUplinkClock(jtr.constant_trace(8e3, rtt_s=0.0), 10, 30.0)
    queues = []
    for ci in range(4):
        g = got.send(ci, 1000.0, 0.0)
        assert g == want.send(ci, 1000.0, 0.0)
        queues.append(g[1])
    assert queues[0] == 0.0
    np.testing.assert_allclose(np.diff(queues), 1.0 - 1.0 / 3.0, rtol=1e-9)
    rng = np.random.RandomState(1)
    got = UplinkClock(make_trace("lte", seed=2), 10, 30.0)
    want = JUplinkClock(jtr.make_trace("lte", seed=2), 10, 30.0)
    for ci in range(30):
        n_bytes, ready = float(rng.uniform(0, 3e5)), float(rng.uniform(0, 1))
        if ci % 3:
            assert got.send(ci, n_bytes, ready) == \
                want.send(ci, n_bytes, ready)
        else:
            sizes = list(rng.uniform(0, 1e5, 4))
            assert got.send_shared(ci, sizes, ready) == \
                want.send_shared(ci, sizes, ready)
        assert got.free_at_s == want.free_at_s
    assert got.capture_s(7) == want.capture_s(7)


# ---------------------------------------------------------------------------
# rate controller and its prep
# ---------------------------------------------------------------------------
def _observations(seed, n=60):
    rng = np.random.RandomState(seed)
    return [dict(n_bytes=float(rng.uniform(1e3, 1e5)),
                 stream_s=float(rng.uniform(0.0, 1.2)),
                 queue_s=float(rng.choice([0.0, rng.uniform(0, 0.5)])),
                 compute_s=float(rng.uniform(0, 0.05)),
                 extra_rtt_s=float(rng.choice([0.0, 0.1])))
            for _ in range(n)]


@pytest.mark.parametrize("budget", [0.2, 0.5, 1.0])
def test_rate_controller_gives_the_reference_knob_sequence(budget):
    got, want = RateController(delay_budget_s=budget), \
        JRateController(delay_budget_s=budget)
    assert got.knobs().__dict__ == want.knobs().__dict__
    levels = set()
    for obs in _observations(int(budget * 10)):
        g = got.observe(ChunkObservation(**obs))
        w = want.observe(JObservation(**obs))
        assert g.__dict__ == w.__dict__ and got.level == want.level
        levels.add(got.level)
    assert len(levels) > 3  # the sequence moved both ways
    assert [(k.__dict__, o.total_delay_s) for k, o in got.history] == \
        [(k.__dict__, o.total_delay_s) for k, o in want.history]
    o = ChunkObservation(n_bytes=1e4, stream_s=0.5, n_streams=4)
    assert (o.bytes_per_stream, o.goodput_bps) == (2500.0, 1.6e5)
    got.reset()
    assert got.level == got.init_level and not got.history


def test_rate_controller_aimd_shape():
    """The reference test's AIMD properties, on the port."""
    ctrl = RateController(delay_budget_s=0.5)
    rich = ctrl.knobs()
    ctrl.observe(ChunkObservation(n_bytes=1e4, stream_s=1.0, queue_s=0.3))
    lean = ctrl.knobs()
    assert lean.qp_hi > rich.qp_hi and lean.alpha > rich.alpha
    assert lean.drop_thresh > rich.drop_thresh
    assert lean.qp_lo == pytest.approx(lean.qp_hi + ctrl.qp_lo_span)
    for _ in range(40):
        ctrl.observe(ChunkObservation(n_bytes=1e4, stream_s=9.0,
                                      queue_s=9.0))
    assert ctrl.knobs().qp_hi == pytest.approx(ctrl.qp_hi_range[1])
    assert ctrl.knobs().qp_lo <= 51.0
    for _ in range(40):
        ctrl.observe(ChunkObservation(n_bytes=1e3, stream_s=0.01))
    assert ctrl.knobs() == rich
    knobs = ctrl.knob_array("cpu")
    assert knobs.dtype == torch.float32 and knobs.device.type == "cpu"
    np.testing.assert_array_equal(
        knobs.numpy(), np.asarray(JRateController().knob_array()))
    assert ControlKnobs(0.3, 31.0, 41.0, 0.1).as_array("cpu").tolist() == \
        pytest.approx([0.3, 31.0, 41.0, 0.1])


def test_controlled_prep_matches_reference(frames):
    """The reference test's drop-all and keep-all cases on its random
    chunk, then the scene's chunk at knobs in between: the same frames,
    QP map and keep, exactly."""
    rng = np.random.RandomState(0)
    cases = [(rng.rand(6, 32, 48, 3).astype(np.float32),
              np.ones((1, 2, 3), np.float32) * 0.9, knobs, 1)
             for knobs in ([0.5, 30.0, 42.0, 1e9], [0.5, 30.0, 42.0, -1.0])]
    scores = rng.rand(1, H // 16, W // 16).astype(np.float32)
    for s in (0, 10):
        feat = np.asarray(j_feature(jnp.asarray(frames[s:s + 10])))
        # just above the median: drops about half the frames
        drop = float(np.median(feat[1:])) + 1e-4
        assert np.abs(feat - drop).min() > MARGIN
        cases.append((frames[s:s + 10], scores, [0.45, 33.6, 43.6, drop],
                      2))
    for chunk, sc, knobs, gamma in cases:
        want = j_prep(jnp.asarray(chunk), jnp.asarray(sc),
                      jnp.asarray(knobs, jnp.float32), gamma=gamma)
        got = _controlled_prep(torch.from_numpy(chunk),
                               torch.from_numpy(sc),
                               torch.tensor(knobs, dtype=torch.float32),
                               gamma=gamma)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    keep = got[2].numpy()
    assert keep[0] and 0 < keep.sum() < len(keep)


# ---------------------------------------------------------------------------
# the engine's trace mode
# ---------------------------------------------------------------------------
def _assert_accounting_matches(got, want):
    assert len(got.chunks) == len(want.chunks)
    for g, w in zip(got.chunks, want.chunks):
        assert g.ci == w.ci
        assert g.bytes == pytest.approx(w.bytes, rel=REL)
        assert g.stream_s == pytest.approx(w.stream_s, rel=REL)
        assert g.queue_s == pytest.approx(w.queue_s, rel=REL, abs=1e-12)
        assert g.extra_rtt_s == w.extra_rtt_s
        assert g.accuracy == pytest.approx(w.accuracy, abs=1e-6)


@pytest.mark.parametrize("impl", ["exact", "fused_exact"])
def test_trace_mode_dds_matches_reference(impl, ref_models, port_models,
                                          frames, _frozen_clocks):
    """DDS under a saturated lte trace (mean 60 kb/s, so each chunk queues
    behind the last): per chunk stream_s, queue_s and extra_rtt_s of the
    reference, the trace's RTT charged and never the constant net's."""
    trace = make_trace("lte", seed=1).scaled_to_mean(6e4)
    j_trace = jtr.make_trace("lte", seed=1).scaled_to_mean(6e4)
    net = NetworkConfig(rtt_s=0.7)
    want = JStreamingEngine(ref_models[0], net=net, trace=j_trace).run(
        JDDSPolicy(), frames,
        refs=j_make_reference(frames, ref_models[0], qp_hi=30))
    got = StreamingEngine(port_models[0], net=net, impl=impl, trace=trace,
                          device="cpu").run(
        DDSPolicy(), frames, refs=make_reference(frames, port_models[0]))
    _assert_accounting_matches(got, want)
    assert all(c.extra_rtt_s == trace.rtt_s for c in got.chunks)
    assert all(c.encode_s == c.overhead_s == 0.0 for c in got.chunks)
    assert max(c.queue_s for c in got.chunks) > 0.0


def test_trace_mode_charges_two_transmissions_once(port_models, frames,
                                                   _frozen_clocks):
    """Two transmissions of one chunk (DDS's two passes) on an idle, fast
    uplink: the second starts when the first ends, which stream_s already
    prices, so queue_s stays 0; each pass pays its own RTT/2. The clocks
    are frozen: a measured encode slower than a chunk interval (a loaded
    host) would queue the next chunk behind it."""
    bw, rtt = 1e9, 0.1
    trace = ttr.constant_trace(bw, rtt_s=rtt)
    r = StreamingEngine(port_models[0], net=NetworkConfig(bw, rtt_s=0.7),
                        trace=trace, device="cpu").run(DDSPolicy(),
                                                       frames[:20])
    for c in r.chunks:
        assert c.queue_s == pytest.approx(0.0, abs=1e-9)
        assert c.stream_s == pytest.approx(c.bytes * 8 / bw + rtt, rel=1e-6)
        assert c.extra_rtt_s == pytest.approx(rtt)


def test_persistent_clock_carries_the_backlog(port_models, frames,
                                              _frozen_clocks):
    """run(clock=, start_chunk=) serves a later segment of one camera's
    timeline: the backlog carries over, capture times and refs continue,
    and the stitched accounting equals one uninterrupted run."""
    dnn, am = port_models
    trace = ttr.constant_trace(3e4, rtt_s=0.02)  # saturated
    engine = StreamingEngine(dnn, impl="fused_exact", trace=trace,
                             device="cpu")
    policy = AccMPEGPolicy(am)
    refs = make_reference(frames, dnn)
    clk = UplinkClock(trace, chunk_size=10, fps=30.0)
    first = engine.run(policy, frames[:20], refs=refs, clock=clk)
    second = engine.run(policy, frames[20:], refs=refs, clock=clk,
                        start_chunk=2)
    assert second.chunks[0].queue_s > 0.0 and second.chunks[0].ci == 2
    full = engine.run(policy, frames, refs=refs)
    stitched = first.chunks + second.chunks
    assert [c.ci for c in full.chunks] == [c.ci for c in stitched] \
        == [0, 1, 2, 3]
    for a, b in zip(stitched, full.chunks):
        assert (a.bytes, a.stream_s, a.queue_s, a.accuracy) == \
            (b.bytes, b.stream_s, b.queue_s, b.accuracy)


def test_controlled_congestion_cuts_bytes_as_the_reference(
        ref_models, port_models, frames):
    """A controlled run on a saturated uplink (50 kb/s) with a 0.05 s
    budget: every chunk's streaming delay alone exceeds the budget, so
    every decision is a decrease whatever the measured compute, and the
    knob path, bytes, queue and accuracy follow the reference's."""
    dnn, am = port_models
    budget = 0.05
    j_ctrl, ctrl = JRateController(delay_budget_s=budget), \
        RateController(delay_budget_s=budget)
    want = JStreamingEngine(ref_models[0], trace=jtr.constant_trace(
        5e4, rtt_s=0.02), controller=j_ctrl).run(
        JControlledPolicy(ref_models[1], j_ctrl), frames,
        refs=j_make_reference(frames, ref_models[0], qp_hi=30))
    got = StreamingEngine(dnn, impl="fused_exact", trace=ttr.constant_trace(
        5e4, rtt_s=0.02), controller=ctrl, device="cpu").run(
        ControlledAccMPEGPolicy(am, ctrl), frames,
        refs=make_reference(frames, dnn))
    assert got.method == want.method == "accmpeg_controlled"
    assert [k.__dict__ for k, _ in ctrl.history] == \
        [k.__dict__ for k, _ in j_ctrl.history]
    assert all(o.stream_s > budget for _, o in ctrl.history)
    for g, w in zip(got.chunks, want.chunks):
        assert g.bytes == pytest.approx(w.bytes, rel=REL)
        assert g.accuracy == pytest.approx(w.accuracy, abs=1e-6)
    assert got.chunks[-1].bytes < 0.7 * got.chunks[0].bytes
    assert max(c.queue_s for c in got.chunks) > 0.0
    # every decision of the run lies away from its threshold
    for (knobs, _), s in zip(ctrl.history, range(0, T, 10)):
        chunk = jnp.asarray(frames[s:s + 10])
        scores = np.asarray(ref_models[1].scores(chunk[:1]))
        assert np.abs(scores - knobs.alpha).min() > MARGIN
        feat = np.asarray(j_feature(chunk))
        assert np.abs(feat - knobs.drop_thresh).min() > MARGIN
