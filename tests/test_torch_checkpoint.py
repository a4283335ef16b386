"""The port's checkpoint manager (``repro_torch.checkpoint.manager``): the
reference's checkpoint cases (``tests/test_checkpoint_data.py``) over
tensor trees, restore onto a device, and checkpoints crossing between the
two packages, which share the on-disk form (``arrays.npz`` keyed by
``"::"``-joined paths, ``manifest.json``).

Tolerances: restored arrays equal what was saved (the npz holds them
exactly); an AccModel restored across packages scores within 1e-6 of
the package that wrote it (the same weights through two conv
libraries on the CPU).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.core import accmodel as jam
from repro.data.video import make_scene
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import tree_paths
from repro_torch.core.accmodel import AccModel
from repro_torch.weights import accmodel_from_numpy, accmodel_to_numpy

SCORE_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch calls (the suite's
    workers share the machine's cores). Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 4, generator=g),
                       "b": torch.zeros(4)},
            "step": torch.tensor(7, dtype=torch.int32),
            "stack": [torch.ones(2), np.arange(3.0)]}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    return np.zeros_like(tree)


def _leaves(tree):
    return list(tree_paths(tree).values())


def _assert_equal_trees(got, want):
    assert tree_paths(got).keys() == tree_paths(want).keys()
    for a, b in zip(_leaves(got), _leaves(want)):
        assert type(a) is type(b)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    state = _state()
    mgr.save(7, state, extra={"note": "hi"})
    restored = mgr.restore(_zeros_like(state))
    _assert_equal_trees(restored, state)
    assert set(tree_paths(state)) == {"params::w", "params::b", "step",
                                      "stack::0", "stack::1"}
    m = mgr.manifest()
    assert m["extra"]["note"] == "hi" and m["step"] == 7
    assert m["n_arrays"] == 5 and m["mode"] == "full"
    assert m["total_bytes"] == (32 + 4 + 1 + 2) * 4 + 3 * 8


def test_save_snapshots_before_the_caller_moves_on(tmp_path):
    """The tree is copied to the host at ``save``: an in-place change
    right after an async save does not reach the checkpoint."""
    mgr = CheckpointManager(tmp_path, async_save=True)
    state = _state()
    want = {k: v.clone() for k, v in state["params"].items()}
    mgr.save(1, state["params"])
    state["params"]["w"].add_(1.0)
    mgr.wait()
    _assert_equal_trees(mgr.restore(_zeros_like(want)), want)


def test_async_save_and_wait(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=True)
    mgr.save(1, _state())
    mgr.wait()
    assert mgr.latest_step() == 1


def test_async_failure_surfaces_on_wait(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=True)
    mgr.save(1, {"a": np.zeros(2)}, extra={"bad": object()})
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        mgr.wait()
    assert mgr.latest_step() is None


def test_atomicity_partial_tmp_ignored(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(5, _state())
    # a crashed save: a stale tmp directory and a final one without its
    # manifest
    (tmp_path / "step_0000000009.tmp-dead").mkdir()
    (tmp_path / "step_0000000010").mkdir()
    assert mgr.latest_step() == 5  # neither is visible
    restored = mgr.restore(_zeros_like(_state()))
    assert int(restored["step"]) == 7


def test_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(s))
    assert mgr.steps() == [3, 4]
    _assert_equal_trees(mgr.restore(_zeros_like(_state()), step=3),
                        _state(3))


def test_restore_missing_key_raises(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(1, {"a": torch.zeros(3)})
    with pytest.raises(KeyError, match="new"):
        mgr.restore({"a": torch.zeros(3), "new": torch.zeros(2)})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore({"a": torch.zeros(3)})


def test_restore_onto_a_device_and_into_the_like_type(tmp_path):
    """``device`` places every array; otherwise a tensor leaf's device and
    type decide, and numpy leaves stay numpy. bfloat16 is stored as
    float32 (numpy has no such type) and comes back as bfloat16. A
    restore onto several cards is module 8."""
    mgr = CheckpointManager(tmp_path, async_save=False)
    bf = torch.randn(5, generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    mgr.save(0, {"x": np.arange(4, dtype=np.float32), "bf": bf,
                 "i": torch.arange(3)})
    like = {"x": np.zeros(4, np.float32),
            "bf": torch.zeros(5, dtype=torch.bfloat16),
            "i": torch.zeros(3, dtype=torch.int64)}
    got = mgr.restore(like)
    assert isinstance(got["x"], np.ndarray)
    assert got["bf"].dtype == torch.bfloat16 and torch.equal(got["bf"], bf)
    placed = mgr.restore(like, device="cpu")
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for v in placed.values())
    assert placed["x"].dtype == torch.float32
    assert torch.equal(placed["i"], torch.arange(3))
    assert mgr.manifest(0)["total_bytes"] == 16 + 20 + 24
    with pytest.raises(NotImplementedError, match="module 8"):
        mgr.restore(like, shardings={"x": None})
    with pytest.raises(NotImplementedError, match="module 8"):
        CheckpointManager(tmp_path, mode="sharded")


def test_state_dict_roundtrip_restores_a_module(tmp_path):
    src = AccModel(8, torch.Generator().manual_seed(3), device="cpu")
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(2, src.state_dict())
    dst = AccModel(8, torch.Generator().manual_seed(4), device="cpu")
    dst.load_state_dict(mgr.restore(dst.state_dict()))
    sd1, sd2 = src.state_dict(), dst.state_dict()
    assert all(torch.equal(sd1[k], sd2[k]) for k in sd1)


def test_crash_during_resave_preserves_old_checkpoint(tmp_path):
    """A process killed between the rename-aside and the landing of a
    re-save: the original checkpoint survives with its own bytes."""
    body = textwrap.dedent(f"""
        import os
        import torch
        from repro_torch.checkpoint.manager import CheckpointManager
        mgr = CheckpointManager({str(tmp_path)!r}, async_save=False)
        mgr.save(0, {{"a": torch.full((4,), 1.0)}}, extra={{"gen": 1}})
        real = os.replace
        def dying(src, dst, *a, **k):
            real(src, dst, *a, **k)
            if ".old-" in str(dst):
                os._exit(17)  # die before the new dir replaces the old
        os.replace = dying
        mgr.save(0, {{"a": torch.full((4,), 2.0)}}, extra={{"gen": 2}})
    """)
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", body], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 17, proc.stderr
    mgr = CheckpointManager(tmp_path, async_save=False)
    assert mgr.steps() == [0]
    restored = mgr.restore({"a": torch.zeros(4)})
    assert torch.equal(restored["a"], torch.full((4,), 1.0))
    assert mgr.manifest(0)["extra"]["gen"] == 1


def test_restore_races_retention(tmp_path):
    """Async saves, whose thread runs retention deletes, racing
    ``restore(latest_step())``: every restore sees an intact checkpoint
    of the step it picked."""
    mgr = CheckpointManager(tmp_path, keep=2, async_save=True)
    base = torch.arange(64, dtype=torch.float64)
    for s in range(20):
        mgr.save(s, {"a": base + s})
        step = mgr.latest_step()
        while step is None:
            step = mgr.latest_step()
        assert step >= max(0, s - 1)
        restored = mgr.restore({"a": torch.zeros(64, dtype=torch.float64)},
                               step=step)
        assert torch.equal(restored["a"], base + step)
    mgr.wait()
    assert mgr.steps() == [18, 19]


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------
def _nest(flat):
    """The reference's nested parameter tree from its flat "a/b/w" form."""
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


@pytest.fixture(scope="module")
def probe():
    return make_scene("dashcam", seed=12, T=2, H=64, W=112).frames


def test_reference_checkpoint_restores_in_the_port(tmp_path, probe):
    """An AccModel the reference saved restores in the port and scores as
    the reference's does."""
    params = jam.accmodel_init(jax.random.PRNGKey(7), 8)
    JCheckpointManager(tmp_path, async_save=False).save(
        3, params, extra={"by": "reference"})
    mgr = CheckpointManager(tmp_path)
    assert mgr.latest_step() == 3 and mgr.manifest()["extra"] == \
        {"by": "reference"}
    like = _nest(accmodel_to_numpy(AccModel(8, device="cpu")))
    port = accmodel_from_numpy(mgr.restore(like), device="cpu")
    np.testing.assert_allclose(
        port.scores(torch.from_numpy(probe)).numpy(),
        np.asarray(jam.AccModel(params).scores(jnp.asarray(probe))),
        atol=SCORE_ATOL)


def test_port_checkpoint_restores_in_the_reference(tmp_path, probe):
    """An AccModel the port saved, in the reference's layout, restores in
    the reference and scores as the port's does."""
    model = AccModel(8, torch.Generator().manual_seed(5), device="cpu")
    CheckpointManager(tmp_path, async_save=False).save(
        4, _nest(accmodel_to_numpy(model)), extra={"by": "port"})
    mgr = JCheckpointManager(tmp_path)
    assert mgr.manifest()["extra"] == {"by": "port"}
    params = mgr.restore(jam.accmodel_init(jax.random.PRNGKey(0), 8))
    np.testing.assert_allclose(
        np.asarray(jam.AccModel(params).scores(jnp.asarray(probe))),
        model.scores(torch.from_numpy(probe)).numpy(), atol=SCORE_ATOL)
