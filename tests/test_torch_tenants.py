"""Multi-tenant fleet serving of the port (``serve/tenants.py``, the
tenant-routed steps of ``serve/steps.py``, ``EngineConfig(tenants=,
tenant_of=)``, ``ScaleDecision.tenant_share``) against the reference's
(``tests/test_tenants.py``) on the CPU, in one process, with the
reference's weights carried across by ``repro_torch.weights``.

Tolerances, each with its reason:
- ``TenantSpec`` / ``validate_tenants`` messages and the autoscaler's
  ``tenant_share``: equal, the same Python on the same inputs;
- the tenant camera step per lane: decoded atol 1e-5, bytes rtol 1e-3,
  scores atol 1e-5 (``tests/test_torch_fleet.py``'s bounds; the port's
  ``fused_exact`` and ``pallas`` held against the reference's ``exact``,
  as there: off the TPU the reference's ``fused_exact`` lowers to its
  drifting ``fast_exact``, ROADMAP queue 3);
- the tenant server step: within 1e-4 of the reference's (float order of
  two conv libraries, as the fleet's server step) and within 1e-5 of the
  port's own per-tenant sequential inference;
- the tenant accuracy reduce: within 1e-6 of the reference's, both
  float32 on the same outputs;
- the engine (``run``, ``serve_loop``, windowed): per stream and chunk
  accuracy within 1e-6 and bytes within rtol 1e-3 of the reference's
  tenanted engine; per tenant within 1e-6 of dedicated port fleets;
- ``calibrate_tenant``: ``test_torch_training.py``'s trainer bounds
  (losses rtol 1e-5, weights atol 1e-6, scores atol 1e-5).

Weights: the detection tenant takes ``tests/test_torch_fleet.py``'s
recipe (heads scaled so detections are sparse and well separated), the
AccModels a last layer scaled x500 so scores sit far from alpha, at the
reference tests' size (64x112, width 8, 4 dashcam streams of 20
frames, seeds 30-33, which ``test_tenant_seed_is_well_posed`` holds away
from every threshold).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.control import ChurnEvent as JChurnEvent
from repro.control import FleetAutoscaler as JFleetAutoscaler
from repro.control import RateController as JRateController
from repro.core import accmodel as jam
from repro.core.aggregate import AggregateConfig as JAggregateConfig
from repro.core.quality import QualityConfig as JQualityConfig
from repro.data.video import make_scene
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import MultiStreamEngine as JMultiStreamEngine
from repro.serve import steps as jsteps
from repro.serve import tenants as jten
from repro.vision import dnn as jv
from repro.vision.train import _flatten
from repro_torch import obs
from repro_torch.control import ChurnEvent, FleetAutoscaler, RateController
from repro_torch.core import training as ttr
from repro_torch.core.aggregate import DEFAULT_TIERS, AggregateConfig, SLOTier
from repro_torch.core.quality import QualityConfig
from repro_torch.engine import EngineConfig, MultiStreamEngine
from repro_torch.obs import CompileCounter
from repro_torch.serve import steps as tsteps
from repro_torch.serve import tenants as tten
from repro_torch.serve.tenants import (TenantSpec, calibrate_tenant,
                                       gather_tree, stack_trees,
                                       tenant_spec_hash, validate_tenants)
from repro_torch.vision import dnn as tv
from repro_torch.weights import (accmodel_from_numpy, accmodel_to_numpy,
                                 final_dnn_from_numpy)
from test_torch_training import (LABEL_SEED, SCORE_ATOL, WEIGHT_ATOL, nets,
                                 scene, shared_accmodel_init)

H, W, CS, T, WIDTH = 64, 112, 10, 20, 8
SEEDS = (30, 31, 32, 33)
QCFG = dict(alpha=0.7, gamma=1, qp_hi=30, qp_lo=46)
KP_QCFG = dict(QCFG, qp_lo=51)  # keypoint's QP pair, paper §6.1
TENANT_OF = {0: 0, 1: 0, 2: 1, 3: 1}
ACC_ATOL, REL, DEC_ATOL, SRV_ATOL, SEQ_ATOL = 1e-6, 1e-3, 1e-5, 1e-4, 1e-5
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


def _np_tree(params):
    return jax.tree_util.tree_map(np.array, params)


def _jnp_tree(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


@pytest.fixture(scope="module")
def weights():
    """{name: (task, numpy params)} for the server DNNs and AccModels."""
    det = _np_tree(jv.init_net("detection", jax.random.PRNGKey(2), WIDTH))
    det["heat"]["c2"]["w"] *= 1000.0
    det["heat"]["c2"]["b"] -= 1.0  # sparse peaks
    det["wh"]["c2"]["w"] *= 1000.0
    out = {"det": ("detection", det),
           "seg": ("segmentation", _np_tree(jv.init_net(
               "segmentation", jax.random.PRNGKey(5), WIDTH))),
           "kp": ("keypoint", _np_tree(jv.init_net(
               "keypoint", jax.random.PRNGKey(6), WIDTH)))}
    for name, key in (("am_det", 1), ("am_seg", 3), ("am_kp", 4)):
        acc = _np_tree(jam.accmodel_init(jax.random.PRNGKey(key), WIDTH))
        acc["c3"]["w"] *= 500.0
        out[name] = (None, acc)
    return out


def _models(weights, pkg):
    """{name: model} of one package."""
    out = {}
    for name, (task, p) in weights.items():
        if pkg == "ref":
            out[name] = jv.FinalDNN(task, _jnp_tree(p)) if task else \
                jam.AccModel(_jnp_tree(p))
        else:
            out[name] = final_dnn_from_numpy(task, p, device="cpu") if task \
                else accmodel_from_numpy(p, device="cpu")
    return out


@pytest.fixture(scope="module")
def ref_m(weights):
    return _models(weights, "ref")


@pytest.fixture(scope="module")
def port_m(weights):
    return _models(weights, "port")


def _tenants(m, pkg, pair=("det", "seg")):
    spec_cls, q_cls = (jten.TenantSpec, JQualityConfig) if pkg == "ref" \
        else (TenantSpec, QualityConfig)
    return tuple(spec_cls(name, m[name], m[f"am_{name}"],
                          qcfg=q_cls(**(KP_QCFG if name == "kp" else QCFG)))
                 for name in pair)


@pytest.fixture(scope="module")
def fleet():
    return np.stack([make_scene("dashcam", seed=s, T=T, H=H, W=W).frames
                     for s in SEEDS])


def _engine(pkg, tenants, **kw):
    if pkg == "ref":
        return JMultiStreamEngine(config=JEngineConfig(
            chunk_size=CS, tenants=tenants, **kw))
    return MultiStreamEngine(config=EngineConfig(
        chunk_size=CS, tenants=tenants, **kw), device="cpu")


def _assert_chunks_match(got, want):
    assert [len(r.chunks) for r in got.streams] == \
        [len(r.chunks) for r in want.streams]
    for gs, ws in zip(got.streams, want.streams):
        for g, w in zip(gs.chunks, ws.chunks):
            assert g.ci == w.ci
            assert g.accuracy == pytest.approx(w.accuracy, abs=ACC_ATOL)
            assert g.bytes == pytest.approx(w.bytes, rel=REL)
            assert g.stream_s == pytest.approx(w.stream_s, rel=REL)


# ---------------------------------------------------------------------------
# specs, validation, stacking
# ---------------------------------------------------------------------------
def _raised(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_tenant_spec_and_validate_tenants_errors(ref_m, port_m):
    """The port raises where the reference does, with its messages."""
    for pkg, m, spec_cls, q_cls, validate in (
            ("ref", ref_m, jten.TenantSpec, JQualityConfig,
             jten.validate_tenants),
            ("port", port_m, TenantSpec, QualityConfig, validate_tenants)):
        spec = spec_cls("t", m["det"], m["am_det"])
        assert spec.task == "detection" and len(spec.tiers) == 3
        other = spec_cls("u", m["seg"], m["am_seg"],
                         qcfg=q_cls(alpha=0.3))
        msgs = [_raised(lambda: spec_cls("t", m["det"], m["am_det"],
                                         tiers=())),
                _raised(lambda: validate(())),
                _raised(lambda: validate((spec, spec))),
                _raised(lambda: validate((spec, spec_cls(
                    "u", m["det"], m["am_det"], qcfg=q_cls(gamma=4))))),
                _raised(lambda: validate((spec, other), "fused")),
                _raised(lambda: validate((spec, other), "fused_exact"))]
        assert validate((spec, other), "fast") == (spec, other)
        if pkg == "ref":
            want = msgs
    assert msgs == want
    dnn = tv.FinalDNN("detection", WIDTH, device="cpu")
    dnn.task = "depth"  # a task the fleet does not know
    with pytest.raises(ValueError, match="unknown task"):
        TenantSpec("d", dnn, port_m["am_det"])
    assert set(tten.TASK_KEYS) == set(jten.TASK_KEYS)
    assert all(tten.TASK_KEYS[k] == jten.TASK_KEYS[k] for k in tten.TASK_KEYS)


def test_engine_config_tenants_validate_like_the_reference(port_m):
    tenants = _tenants(port_m, "port")
    cfg = EngineConfig(tenants=list(tenants), tenant_of={"2": 1})
    assert cfg.tenants == tenants and cfg.tenant_of == {2: 1}
    assert cfg.tenanted and not EngineConfig(tenants=tenants[:1]).tenanted
    with pytest.raises(ValueError, match="config has 2"):
        EngineConfig(tenants=tenants, tenant_of={0: 3})
    with pytest.raises(ValueError, match="without tenants"):
        EngineConfig(tenant_of={0: 0})
    with pytest.raises(ValueError, match="fuses one fleet-wide"):
        EngineConfig(impl="fused", tenants=_tenants(port_m, "port",
                                                     ("seg", "kp")))


def test_stack_and_gather_tree_roundtrip(port_m):
    sds = [port_m["am_det"].state_dict(), port_m["am_seg"].state_dict()]
    stacked = stack_trees(sds)
    assert all(v.shape[0] == 2 for v in stacked.values())
    for i, sd in enumerate(sds):
        got = gather_tree(stacked, i)
        assert list(got) == list(sd)
        assert all(torch.equal(got[k], sd[k]) for k in sd)
    with pytest.raises(ValueError, match="structure differs"):
        stack_trees([sds[0], port_m["det"].state_dict()])
    wide = tv.FinalDNN("segmentation", 2 * WIDTH, device="cpu")
    with pytest.raises(ValueError, match="shapes differ"):
        stack_trees([port_m["seg"].state_dict(), wide.state_dict()])


def test_tenant_seed_is_well_posed(ref_m, fleet):
    """Every chunk head's AccModel scores (each tenant's) lie more than
    1e-5 from alpha, both QP levels are used, and the detection tenant's
    suppressed heat lies more than 1e-5 from the decode threshold."""
    margins, high = [], []
    for s in range(0, T, CS):
        heads = jnp.asarray(fleet[:, s])
        for name in ("det", "seg"):
            sc = np.asarray(ref_m[f"am_{name}"].scores(heads))
            margins.append(float(np.abs(sc - QCFG["alpha"]).min()))
            high.append(float((sc >= QCFG["alpha"]).mean()))
        for sid in (0, 1):
            o = ref_m["det"].predict(jnp.asarray(fleet[sid, s:s + CS]))
            keep = np.asarray(jv.detection_keep_heat(o))
            margins.append(float(np.abs(keep[keep > 0] - 0.3).min()))
    assert min(margins) > MARGIN
    assert 0.05 < float(np.mean(high)) < 0.95


# ---------------------------------------------------------------------------
# the tenant-routed steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("impl,ref_impl", [("fast", "fast"),
                                           ("fused_exact", "exact"),
                                           ("pallas", "exact")])
def test_tenant_camera_step_matches_reference(impl, ref_impl, mask, ref_m,
                                              port_m, fleet):
    """Per lane against the reference's tenant camera step, and each lane
    equal to the port's dedicated camera step of its tenant. The second
    chunk: coded under the detection tenant's map, the first chunk of
    seed 33 has a round-half flip between the packages (frame 2)."""
    chunks = fleet[:, CS:]
    tids = np.array([1, 0, 1, 0], np.int32)
    active = np.array([1, 1, 0, 1], np.int32)
    jargs = (jnp.asarray(tids),) + ((jnp.asarray(active),) if mask else ())
    want = jsteps.make_tenant_camera_fleet_step(
        _tenants(ref_m, "ref"), impl=ref_impl, mask=mask)(
        jnp.asarray(chunks), *jargs)
    step = tsteps.make_tenant_camera_fleet_step(_tenants(port_m, "port"),
                                                impl=impl, mask=mask)
    targs = (tids,) + ((torch.from_numpy(active),) if mask else ())
    got = step(torch.from_numpy(chunks), *targs)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=DEC_ATOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=REL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=1e-5)
    if mask:
        assert float(got[1][2].abs().sum()) == 0.0
    for t, name in enumerate(("det", "seg")):
        lanes = np.flatnonzero(tids == t)
        own = tsteps.make_camera_fleet_step(
            port_m[f"am_{name}"], QualityConfig(**QCFG), impl=impl)(
            torch.from_numpy(chunks[lanes]))
        for j, lane in enumerate(lanes):
            if mask and not active[lane]:
                continue
            assert torch.equal(got[0][lane], own[0][j])
            assert torch.equal(got[1][lane], own[1][j])


def test_tenant_camera_step_gives_each_lane_its_tenants_qp(port_m, fleet):
    """Tenants with their own QP ladders (segmentation (30, 46), keypoint
    (30, 51)): under ``fast`` each lane is coded with its own tenant's
    QP map; the fused backends refuse the mix."""
    tenants = _tenants(port_m, "port", ("seg", "kp"))
    chunks = torch.from_numpy(fleet[:, :CS])
    tids = np.array([0, 1, 1, 0])
    got = tsteps.make_tenant_camera_fleet_step(tenants, impl="fast")(
        chunks, torch.from_numpy(tids))
    for t, spec in enumerate(tenants):
        lanes = np.flatnonzero(tids == t)
        own = tsteps.make_camera_fleet_step(spec.accmodel, spec.qcfg,
                                            impl="fast")(chunks[lanes])
        assert torch.equal(got[1][lanes], own[1])
        assert torch.equal(got[0][lanes], own[0])
    with pytest.raises(ValueError, match="heterogeneous"):
        tsteps.make_tenant_camera_fleet_step(tenants, impl="fused")
    with pytest.raises(ValueError, match="outside"):
        tsteps.TenantLanes([0, 2], 2, "cpu")
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        tsteps.make_tenant_server_fleet_step(tenants, mesh=object())


def test_tenant_server_step_matches_reference_and_sequential(ref_m, port_m):
    """The union outputs against the reference's tenant server step, and
    each lane against its own tenant's DNN run on that lane alone."""
    rng = np.random.default_rng(0)
    decoded = rng.random((4, CS, H, W, 3)).astype(np.float32)
    tids = np.array([0, 1, 0, 1], np.int32)
    want = jsteps.make_tenant_server_fleet_step(_tenants(ref_m, "ref"))(
        jnp.asarray(decoded), jnp.asarray(tids))
    tenants = _tenants(port_m, "port")
    got = tsteps.make_tenant_server_fleet_step(tenants)(
        torch.from_numpy(decoded), tids)
    assert set(got) == set(want) == {"heat", "wh", "off", "keep", "seg"}
    for lane, t in enumerate(tids):
        spec = tenants[t]
        seq = spec.dnn.predict(torch.from_numpy(decoded[lane]))
        if spec.task == "detection":
            seq["keep"] = tv.detection_keep_heat(seq)
        for k in tten.TASK_KEYS[spec.task]:
            np.testing.assert_allclose(got[k][lane].numpy(),
                                       np.asarray(want[k][lane]),
                                       atol=SRV_ATOL, err_msg=k)
            np.testing.assert_allclose(got[k][lane].numpy(),
                                       seq[k].numpy(), atol=SEQ_ATOL,
                                       err_msg=k)
        foreign = set(got) - set(tten.TASK_KEYS[spec.task])
        assert all(float(got[k][lane].abs().max()) == 0.0 for k in foreign)


@pytest.mark.parametrize("pair", [("seg", "kp"), ("kp", "seg")])
def test_tenant_accuracy_reduce_matches_reference(pair, ref_m, port_m,
                                                  fleet):
    chunk = fleet[:, :CS]
    noisy = np.clip(chunk + 0.05 * np.random.RandomState(0).randn(
        *chunk.shape).astype(np.float32), 0, 1)
    tids = np.array([0, 1, 1, 0], np.int32)
    jt, tt = _tenants(ref_m, "ref", pair), _tenants(port_m, "port", pair)
    srv_j = jsteps.make_tenant_server_fleet_step(jt)
    want = np.asarray(jsteps.make_tenant_accuracy_reduce_step(jt)(
        srv_j(jnp.asarray(noisy), jnp.asarray(tids)),
        srv_j(jnp.asarray(chunk), jnp.asarray(tids)), jnp.asarray(tids)))
    srv_t = tsteps.make_tenant_server_fleet_step(tt)
    got = tsteps.make_tenant_accuracy_reduce_step(tt)(
        srv_t(torch.from_numpy(noisy), tids),
        srv_t(torch.from_numpy(chunk), tids), tids)
    np.testing.assert_allclose(got.numpy(), want, atol=ACC_ATOL, rtol=0)
    assert float(got.min()) < 1.0


# ---------------------------------------------------------------------------
# the tenanted engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("detail", ["chunks", "legacy"])
@pytest.mark.parametrize("impl,ref_impl", [("fast", "fast"),
                                           ("fused_exact", "exact")])
def test_two_tenant_run_matches_reference_and_dedicated(
        impl, ref_impl, detail, ref_m, port_m, fleet):
    want = _engine("ref", _tenants(ref_m, "ref"), impl=ref_impl,
                   tenant_of=TENANT_OF, autoscaler=JFleetAutoscaler()
                   ).run(fleet)
    eng = _engine("port", _tenants(port_m, "port"), impl=impl,
                  detail=detail, tenant_of=TENANT_OF,
                  autoscaler=FleetAutoscaler())
    got = eng.run(fleet)
    assert got.tenant_ids == want.tenant_ids == [0, 0, 1, 1]
    _assert_chunks_match(got, want)
    assert got.accuracy_by_tenant() == pytest.approx(
        want.accuracy_by_tenant(), abs=ACC_ATOL)
    assert eng.last_scale.tenant_share == (0.5, 0.5)
    for t, name in enumerate(("det", "seg")):
        ded = MultiStreamEngine(port_m[name], port_m[f"am_{name}"],
                                config=EngineConfig(
                                    qcfg=QualityConfig(**QCFG), impl=impl,
                                    chunk_size=CS), device="cpu").run(
            fleet[2 * t:2 * t + 2])
        assert got.accuracy_by_tenant()[t] == pytest.approx(
            ded.accuracy, abs=ACC_ATOL)


def _churn(mod):
    return dict(initial=(0, 1, 2), events=[
        mod(1, join=(3,), leave=(0,))])


def test_two_tenant_serve_loop_matches_reference_and_splits_capacity(
        ref_m, port_m, fleet):
    """Under churn (det, det, seg, then det, seg, seg) against the
    reference's tenanted loop, the capacity split included; without churn
    against dedicated port fleets."""
    want = _engine("ref", _tenants(ref_m, "ref"), impl="fast",
                   tenant_of=TENANT_OF, autoscaler=JFleetAutoscaler()
                   ).serve_loop(fleet, **_churn(JChurnEvent))
    got = _engine("port", _tenants(port_m, "port"), impl="fast",
                  tenant_of=TENANT_OF, autoscaler=FleetAutoscaler()
                  ).serve_loop(fleet, **_churn(ChurnEvent))
    assert got.stream_ids == want.stream_ids == [0, 1, 2, 3]
    assert got.tenant_ids == want.tenant_ids == [0, 0, 1, 1]
    _assert_chunks_match(got, want)
    shares = [d.tenant_share for d in got.decisions]
    assert shares == [d.tenant_share for d in want.decisions]
    assert shares == [pytest.approx((2 / 3, 1 / 3)),
                      pytest.approx((1 / 3, 2 / 3))]

    full = _engine("port", _tenants(port_m, "port"), impl="fast",
                   tenant_of=TENANT_OF, autoscaler=FleetAutoscaler()
                   ).serve_loop(fleet, rescale=False)
    for t, name in enumerate(("det", "seg")):
        ded = MultiStreamEngine(port_m[name], port_m[f"am_{name}"],
                                config=EngineConfig(
                                    qcfg=QualityConfig(**QCFG), impl="fast",
                                    chunk_size=CS,
                                    autoscaler=FleetAutoscaler()),
                                device="cpu").serve_loop(
            fleet[2 * t:2 * t + 2], rescale=False)
        assert full.accuracy_by_tenant()[t] == pytest.approx(
            ded.accuracy, abs=ACC_ATOL)


@pytest.mark.parametrize("pair,reduce", [(("det", "seg"), "host"),
                                         (("seg", "kp"), "device")])
def test_windowed_per_tenant_aggregate_matches_reference(pair, reduce, ref_m,
                                                         port_m, fleet):
    """Windowed serving under churn: per-tenant accuracy, volume and SLO
    attainment against the reference's; a fleet of segmentation and
    keypoint tenants reduces accuracy on the device (the tenant reduce
    step), one with a detection tenant scores on the host."""
    tiers = (DEFAULT_TIERS, tuple(SLOTier(t.name, t.slo_s * 2, t.weight)
                                  for t in DEFAULT_TIERS))
    kw = dict(impl="fast", detail="windowed", sim_encode_s=0.05,
              tenant_of=TENANT_OF)
    jt = tuple(jten.TenantSpec(s.name, s.dnn, s.accmodel, qcfg=s.qcfg,
                               tiers=tr)
               for s, tr in zip(_tenants(ref_m, "ref", pair), tiers))
    tt = tuple(TenantSpec(s.name, s.dnn, s.accmodel, qcfg=s.qcfg, tiers=tr)
               for s, tr in zip(_tenants(port_m, "port", pair), tiers))
    want = _engine("ref", jt, aggregate=JAggregateConfig(window=2), **kw
                   ).serve_loop(fleet, rescale=False, **_churn(JChurnEvent))
    eng = _engine("port", tt, aggregate=AggregateConfig(window=2), **kw)
    reg = obs.enable(host=0)[1]
    try:
        got = eng.serve_loop(fleet, rescale=False, **_churn(ChurnEvent))
    finally:
        obs.disable()
    assert (eng._acc_step is not None) == (reduce == "device")
    g, w = got.aggregate, want.aggregate
    assert g.tenanted and g.n_tenants == 2 and g.tenant_of == w.tenant_of
    assert np.array_equal(g.t_n, w.t_n)
    np.testing.assert_allclose(g.accuracy_by_tenant(),
                               w.accuracy_by_tenant(), atol=ACC_ATOL)
    for a, b in zip(g.attainment_by_tenant(), w.attainment_by_tenant()):
        assert a.keys() == b.keys()
        np.testing.assert_equal([a[k] for k in a], [b[k] for k in b])
    assert got.accuracy_by_tenant() == g.accuracy_by_tenant()
    assert reg.get("tenant_lanes_active", tenant=pair[1]).value == 2
    assert reg.get("tenant_chunks_served", tenant=pair[0]).value == \
        int(g.t_n[0])


def test_mixed_tenant_churn_builds_nothing_new(port_m):
    """One build per padded shape (1, 2, 4) and a second schedule with
    other tenant mixes on the same shapes builds and warms nothing."""
    frames = np.stack([make_scene("dashcam", seed=50 + i, T=4 * CS, H=H,
                                  W=W).frames for i in range(4)])
    eng = _engine("port", _tenants(port_m, "port"), impl="fused",
                  tenant_of={0: 0, 1: 1, 2: 0, 3: 1},
                  autoscaler=FleetAutoscaler())
    first = eng.serve_loop(
        frames, initial=(0,),
        events=[ChurnEvent(1, join=(1,)), ChurnEvent(2, join=(2, 3)),
                ChurnEvent(3, leave=(1, 2, 3))], rescale=False)
    assert first.shapes == [1, 2, 4]
    counter = CompileCounter.for_engine(eng)
    counter.assert_total(steps=1, warm=3)
    second = eng.serve_loop(
        frames, initial=(0, 1, 2, 3),
        events=[ChurnEvent(1, leave=(2, 3)), ChurnEvent(2, leave=(1,)),
                ChurnEvent(3, join=(3,))], rescale=False)
    counter.assert_no_recompiles("mixed-tenant re-admission")
    assert second.shapes == [1, 2, 4]
    assert all(c.bytes > 0 for r in second.streams for c in r.chunks)


def test_tenanted_engine_refuses_a_controller_and_a_second_dnn(ref_m,
                                                                port_m):
    """As the reference's: a rate controller's knobs are fleet-wide, the
    tenants' quality configs are not."""
    tenants = _tenants(port_m, "port")
    with pytest.raises(ValueError, match="controller") as got:
        _engine("port", tenants, controller=RateController())
    with pytest.raises(ValueError, match="controller") as want:
        _engine("ref", _tenants(ref_m, "ref"), controller=JRateController())
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="do not also pass"):
        MultiStreamEngine(port_m["det"], None, config=EngineConfig(
            tenants=tenants), device="cpu")


def test_single_tenant_is_the_untenanted_engine(port_m, fleet):
    spec = TenantSpec("only", port_m["det"], port_m["am_det"],
                      qcfg=QualityConfig(**QCFG))
    plain = MultiStreamEngine(port_m["det"], port_m["am_det"],
                              config=EngineConfig(
                                  qcfg=QualityConfig(**QCFG), impl="fast",
                                  chunk_size=CS), device="cpu").run(fleet)
    eng = _engine("port", (spec,), impl="fast")
    one = eng.run(fleet)
    assert not eng._tenanted and one.tenant_ids is None
    assert [(c.ci, c.accuracy, c.bytes, c.queue_s)
            for r in one.streams for c in r.chunks] == \
        [(c.ci, c.accuracy, c.bytes, c.queue_s)
         for r in plain.streams for c in r.chunks]
    with pytest.raises(ValueError, match="untenanted"):
        one.accuracy_by_tenant()


# ---------------------------------------------------------------------------
# calibrate_tenant: onboarding a DNN, and its cache
# ---------------------------------------------------------------------------
def test_calibrate_tenant_matches_reference(nets, scene,
                                            shared_accmodel_init):
    """The same initial weights (patched in both packages), two epochs:
    the trained AccModel's weights and scores, and the spec around it."""
    want = jten.calibrate_tenant(
        "det", jv.FinalDNN("detection", _jnp_tree(nets["detection"])),
        scene.frames, epochs=2, width=WIDTH)
    got = calibrate_tenant(
        "det", final_dnn_from_numpy("detection", nets["detection"],
                                    device="cpu"),
        scene.frames, epochs=2, width=WIDTH)
    assert (got.name, got.task, got.accmodel.name, got.tiers) == \
        (want.name, want.task, want.accmodel.name, DEFAULT_TIERS)
    flat_want = _flatten(_np_tree(want.accmodel.params))
    flat_got = accmodel_to_numpy(got.accmodel)
    for k in flat_want:
        np.testing.assert_allclose(flat_got[k], flat_want[k],
                                   atol=WEIGHT_ATOL, err_msg=k)
    probe = make_scene("dashcam", seed=LABEL_SEED + 1, T=2, H=96,
                       W=160).frames
    np.testing.assert_allclose(
        got.accmodel.scores(torch.from_numpy(probe)).numpy(),
        np.asarray(want.accmodel.scores(jnp.asarray(probe))),
        atol=SCORE_ATOL)


def test_calibrate_tenant_caches_per_spec_hash(tmp_path, monkeypatch,
                                               port_m):
    frames = make_scene("surf", seed=7, T=4, H=H, W=W).frames
    kw = dict(epochs=1, width=WIDTH, cache_dir=tmp_path)
    first = calibrate_tenant("seg", port_m["seg"], frames, **kw)
    (cache,) = tmp_path.iterdir()

    def no_training(*a, **k):
        raise AssertionError("a cached spec trained again")

    monkeypatch.setattr(ttr, "train_accmodel", no_training)
    again = calibrate_tenant("seg", port_m["seg"], frames, **kw)
    assert list(tmp_path.iterdir()) == [cache]
    assert again.accmodel.name == first.accmodel.name == "accmodel[seg]"
    sd1, sd2 = first.accmodel.state_dict(), again.accmodel.state_dict()
    assert all(torch.equal(sd1[k], sd2[k]) for k in sd1)
    # the hash moves with the DNN's parameters, the clips and every
    # hyperparameter, and only with them
    hyper = dict(qp_hi=30, qp_lo=40, epochs=1, batch=4, width=WIDTH,
                 seed=0, pos_weight=4.0, label_alpha=0.1)
    base = tenant_spec_hash(port_m["seg"], frames, hyper)
    assert base == tenant_spec_hash(port_m["seg"], frames.copy(),
                                    dict(hyper))
    assert cache.name == f"tenant_{base[:16]}"
    moved = tv.FinalDNN("segmentation", WIDTH, device="cpu")
    moved.load_state_dict(port_m["seg"].state_dict())
    assert tenant_spec_hash(moved, frames, hyper) == base
    with torch.no_grad():
        moved.seg.c2.bias.add_(1e-3)
    other = [tenant_spec_hash(moved, frames, hyper),
             tenant_spec_hash(port_m["seg"], frames[:3], hyper),
             tenant_spec_hash(port_m["seg"], frames * 0.5, hyper),
             tenant_spec_hash(port_m["kp"], frames, hyper)]
    other += [tenant_spec_hash(port_m["seg"], frames, dict(hyper, **{k: v}))
              for k, v in (("qp_lo", 42), ("epochs", 2), ("seed", 1),
                           ("label_alpha", 0.2))]
    assert len({base, *other}) == 1 + len(other)
