"""The port's telemetry plane (``repro_torch.obs``) against the reference's
on the CPU: the copied registry and tracer, the build counter that stands
in for the reference's jit-compile counter, the rate controller's, the
autoscaler's and ``warm_ready``'s reports, and the fleet engine with the
plane on and off.

Tolerances, each with its reason:
- registry exports, Chrome traces, stage summaries and histogram merges
  on the same records: equal, the same code on the same numbers;
- controller and autoscaler reports on the same inputs: equal series and
  equal instants (names and arguments);
- the engine: telemetry on and off give identical accuracy, bytes and
  delays (the plane reads only what the engine already computed), and
  the stage counters equal ``FleetTiming``'s sums to rounding (rel 1e-9).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro.control import autoscaler as jas
from repro.control import controller as jctl
from repro.core import pipeline as jp
from repro.engine import policies as jpol
from repro_torch import obs
from repro_torch.control import (ChurnEvent, FleetAutoscaler, RateController,
                                 constant_trace)
from repro_torch.control.controller import ChunkObservation
from repro_torch.core import aggregate as ta
from repro_torch.core import pipeline as tp
from repro_torch.core.accmodel import AccModel
from repro_torch.core.pipeline import NetworkConfig
from repro_torch.data.video import make_scene
from repro_torch.engine import EngineConfig, MultiStreamEngine
from repro_torch.engine import policies as tpol
from repro_torch.obs import CompileCounter, MetricsRegistry, Tracer
from repro_torch.vision.dnn import FinalDNN

H, W, CS = 48, 64, 5


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


@pytest.fixture(autouse=True)
def _plane_off():
    """The ambient stores are process-wide: every test leaves both
    planes off, whatever it did."""
    yield
    obs.disable()
    jobs.disable()


def _series(reg):
    return json.dumps(reg.series(), sort_keys=True)


def _instants(tracer, stage):
    return [(e.name, e.args) for e in tracer.stage_events(stage)]


# ---------------------------------------------------------------------------
# the copied stores
# ---------------------------------------------------------------------------
def _fill(reg, seed):
    rng = np.random.RandomState(seed)
    reg.counter("c", stage="camera").inc(float(rng.rand()))
    reg.counter("c", stage="server").inc(2.0)
    reg.gauge("g").set(float(rng.rand()))
    h = reg.histogram("h", stage="host")
    h.observe_many(rng.lognormal(-3, 2, size=50))
    h.observe(0.5)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_exports_match_reference(seed):
    got = _fill(MetricsRegistry(host=1), seed)
    want = _fill(jobs.MetricsRegistry(host=1), seed)
    assert _series(got) == _series(want)
    assert got.to_prometheus() == want.to_prometheus()
    strip = [{k: v for k, v in json.loads(line).items() if k != "unix_time"}
             for line in got.to_jsonl().splitlines()]
    assert strip == [{k: v for k, v in json.loads(line).items()
                      if k != "unix_time"}
                     for line in want.to_jsonl().splitlines()]
    a = got.get("h", stage="host")
    b = _fill(MetricsRegistry(), seed + 10).get("h", stage="host")
    ja_ = want.get("h", stage="host")
    jb = _fill(jobs.MetricsRegistry(), seed + 10).get("h", stage="host")
    assert a.merge(b).sample() == ja_.merge(jb).sample()
    assert a.quantile(0.9) == ja_.quantile(0.9)


def test_traces_merge_and_summarise_as_the_reference():
    payloads = []
    for host in (0, 1):
        tr = Tracer(host=host)
        for ci in range(3):
            tr.complete("camera", "camera", 10.0 + ci, 0.01 * (ci + 1),
                        ci=ci)
            tr.complete("scoring", "scoring", 10.5 + ci, 0.002, ci=ci)
        tr.instant("churn", stage="events", ci=1, join=[2], leave=[])
        with tr.span("block", stage="admission"):
            pass
        payloads.append(json.loads(json.dumps(tr.payload())))
    assert json.dumps(obs.merge_host_traces(payloads), sort_keys=True) == \
        json.dumps(jobs.merge_host_traces(payloads), sort_keys=True)
    assert obs.stage_summary(payloads) == jobs.stage_summary(payloads)
    assert obs.STAGES == jobs.STAGES


def test_enable_disable_env_and_profile_region(monkeypatch):
    assert not obs.enabled()
    tr, reg = obs.enable(host=3)
    assert obs.enabled() and obs.get_tracer() is tr and reg.host == 3
    assert obs.disable() == (tr, reg) and not obs.enabled()
    monkeypatch.setenv(obs.ENV_OBS, "0")
    assert not obs.enable_from_env()
    monkeypatch.setenv(obs.ENV_OBS, "1")
    assert obs.enable_from_env(host=2) and obs.get_metrics().host == 2
    with pytest.raises(NotImplementedError, match="module 8"):
        obs.profile_region("/nowhere")
    assert sorted(obs.__all__) == sorted(jobs.__all__)


def test_compile_counter_counts_the_engines_builds():
    steps, warm = {}, {}
    counter = CompileCounter(steps=steps, warm=warm, extra=[0] * 7)
    tr, reg = obs.enable(host=0)
    steps["a"] = 1
    warm["x"] = warm["y"] = 1
    assert counter.growth() == {"steps": 1, "warm": 2}
    with pytest.raises(AssertionError, match="warm: 0->2"):
        counter.assert_no_recompiles("test")
    assert counter.publish(context="warmup") == {"steps": 1, "warm": 2}
    assert reg.get("jit_cache_size", program="warm").value == 2
    assert reg.get("jit_cache_size", program="extra").value == 7
    assert reg.get("jit_recompiles", program="steps").value == 1
    assert [e.name for e in tr.stage_events("warmup")] == ["recompile"] * 2
    assert counter.publish() == {}  # re-baselined
    counter.assert_no_recompiles()
    counter.assert_total(steps=1, warm=2)
    with pytest.raises(TypeError, match="not a sized cache"):
        CompileCounter(bad=3)


# ---------------------------------------------------------------------------
# the control plane's reports, against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
def test_controller_reports_as_the_reference(seed):
    rng = np.random.RandomState(seed)
    # congested, headroom and hold first, then random outcomes
    obs_kw = [dict(n_bytes=1e5, stream_s=s) for s in (2.0, 0.1, 0.45)]
    obs_kw += [dict(n_bytes=float(rng.rand() * 1e5),
                    stream_s=float(rng.rand() * 1.2),
                    queue_s=float(rng.rand() * 0.3 * (i % 2)),
                    compute_s=0.05, n_streams=3) for i in range(12)]
    got_c, want_c = RateController(0.5), jctl.RateController(0.5)
    tr, reg = obs.enable(host=0)
    jtr, jreg = jobs.enable(host=0)
    for kw in obs_kw:
        got_c.observe(ChunkObservation(**kw))
        want_c.observe(jctl.ChunkObservation(**kw))
    assert _series(reg) == _series(jreg)
    assert _instants(tr, "controller") == _instants(jtr, "controller")
    assert {e.name for e in tr.stage_events("controller")} == \
        {"decrease", "increase"}
    assert reg.get("controller_level").value == got_c.level


def test_autoscaler_reports_as_the_reference():
    timings = [(tp.FleetTiming(camera_s=[c], server_s=[s], host_s=[h],
                               wall_s=1.0),
                jp.FleetTiming(camera_s=[c], server_s=[s], host_s=[h],
                               wall_s=1.0))
               for c, s, h in ((1.0, 0.1, 0.1), (0.1, 0.9, 0.1),
                               (0.1, 0.1, 0.1), (0.5, 0.5, 0.5))]
    got_s, want_s = FleetAutoscaler(), jas.FleetAutoscaler()
    tr, reg = obs.enable(host=0)
    jtr, jreg = jobs.enable(host=0)
    depth = 2
    for tt, tj in timings:
        d = got_s.decide(tt, 4, batch_depth=depth, n_devices=4)
        want_s.decide(tj, 4, batch_depth=depth, n_devices=4)
        depth = d.batch_depth
    for n in (3, 2, 5, 0, 1):
        got_s.admit(n)
        want_s.admit(n)
    assert _series(reg) == _series(jreg)
    for stage in ("autoscaler", "admission"):
        assert _instants(tr, stage) == _instants(jtr, stage)
    assert reg.get("admission_compiles_total").value == 3


def test_warm_ready_reports_as_the_reference():
    tr, reg = obs.enable(host=0)
    jtr, jreg = jobs.enable(host=0)
    out = tpol.warm_ready("accmpeg", torch.device("cpu"),
                          lambda: torch.zeros(2), lambda: torch.ones(3))
    jpol.warm_ready("accmpeg", lambda: jnp.zeros(2), lambda: jnp.ones(3))
    assert torch.equal(out, torch.ones(3))
    for r in (reg, jreg):
        assert r.get("warm_compiles_total", policy="accmpeg").value == 1
        assert r.get("warmup_seconds").count == 1
    got, want = tr.stage_events("warmup"), jtr.stage_events("warmup")
    assert [(e.name, e.phase, e.args) for e in got] == \
        [(e.name, e.phase, e.args) for e in want] == \
        [("warm_compile", "X", {"policy": "accmpeg", "n_programs": 2})]


# ---------------------------------------------------------------------------
# the engine with the plane on
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    g = torch.Generator().manual_seed(0)
    return (FinalDNN("segmentation", width=8, generator=g, device="cpu"),
            AccModel(width=8, generator=g, device="cpu"))


@pytest.fixture(scope="module")
def fleet():
    return np.stack([make_scene("dashcam", seed=70 + i, T=3 * CS, H=H,
                                W=W).frames for i in range(3)])


def _engine(models, **kw):
    return MultiStreamEngine(*models, config=EngineConfig(
        impl="fast", chunk_size=CS, net=NetworkConfig.shared(2.5e6, 3),
        sim_encode_s=0.05, **kw), device="cpu")


def _digest(res):
    if res.aggregate is not None:
        return json.dumps(res.aggregate.to_wire(), sort_keys=True)
    return [[c.ci, c.accuracy, c.bytes, c.encode_s, c.stream_s, c.queue_s]
            for run in res.streams for c in run.chunks]


EVENTS = [ChurnEvent(1, leave=(2,)), ChurnEvent(2, join=(2,))]


@pytest.mark.parametrize("detail", ["chunks", "windowed"])
@pytest.mark.parametrize("overlap", [True, False])
def test_serve_loop_identical_with_the_plane_on(detail, overlap, models,
                                                fleet):
    """Telemetry on against off on one churn schedule: the same results,
    and the plane saw every interval: camera spans match ``FleetTiming``,
    the stage counters equal its sums, churn left its instants and the
    windowed run its SLO gauges."""
    kw = dict(detail=detail, overlap=overlap,
              aggregate=ta.AggregateConfig(window=2))
    # rescale=False: a decision read off the wall clock could end the
    # overlap and warm the shape once more in one of the two runs
    res_off = _engine(models, **kw).serve_loop(fleet, events=EVENTS,
                                               rescale=False)
    tr, reg = obs.enable(host=0)
    res_on = _engine(models, **kw).serve_loop(fleet, events=EVENTS,
                                              rescale=False)
    obs.disable()
    assert _digest(res_on) == _digest(res_off)
    cam = tr.stage_events("camera")
    assert [e.args["ci"] for e in cam] == res_on.served_cis == [0, 1, 2]
    assert [e.args["active"] for e in cam] == [3, 2, 3]
    assert [e.args["lanes"] for e in cam] == [4, 4, 4]
    for stage, series in (("camera", res_on.timing.camera_s),
                          ("server", res_on.timing.server_s),
                          ("host", res_on.timing.host_s)):
        assert reg.get("stage_seconds_total", stage=stage).value == \
            pytest.approx(float(np.sum(series)), rel=1e-9)
    assert reg.get("churn_leaves_total").value == 1
    assert reg.get("churn_joins_total").value == 1
    assert len(tr.stage_events("scoring")) == 3
    assert reg.get("admissions_total").value == 3
    assert reg.get("admission_compiles_total").value == 1
    assert reg.get("chunks_served_total").value == 3 + 2 + 3
    assert reg.get("warm_compiles_total").value == 1
    assert [e.name for e in tr.stage_events("warmup")] == ["warm_compile"]
    if detail == "windowed":
        nbytes = res_on.aggregate.sum_bytes
        assert reg.get("slo_attainment", tier="gold") is not None
    else:
        nbytes = sum(c.bytes for r in res_on.streams for c in r.chunks)
    assert reg.get("wire_bytes_total").value == pytest.approx(nbytes,
                                                              rel=1e-9)
    assert {e["pid"] for e in tr.chrome_trace()["traceEvents"]} == {0}
    assert reg.to_prometheus() and reg.to_jsonl()


def test_run_with_trace_and_controller_reports(models, fleet):
    """``run`` on a trace with the controller: the plane on changes
    nothing, the uplink spans carry the modelled backlog, and the
    controller's decisions are counted once per finished chunk."""
    kw = dict(trace=constant_trace(2e5, rtt_s=0.02))
    res_off = _engine(models, controller=RateController(0.3), **kw).run(fleet)
    tr, reg = obs.enable(host=0)
    ctrl = RateController(0.3)
    res_on = _engine(models, controller=ctrl, **kw).run(fleet)
    obs.disable()
    assert _digest(res_on) == _digest(res_off)
    assert len(ctrl.history) == 3
    assert sum(reg.get("controller_decisions_total", action=a).value
               for a in ("increase", "decrease", "hold")
               if reg.get("controller_decisions_total", action=a)) == 3
    uplink = tr.stage_events("uplink")
    assert len(uplink) == 3 and all(e.args["modelled"] for e in uplink)
    assert [e.args["queue_s"] for e in uplink] == \
        [r.chunks[i].queue_s for i in range(3) for r in res_on.streams[:1]]
