"""Fault-tolerant checkpointing (port of ``repro.checkpoint.manager``).

- atomic: writes land in ``step_<N>.tmp-<nonce>`` and are ``os.replace``d
  into place, so a crash mid-save can never corrupt the latest checkpoint;
  a re-save renames the old step aside (``.old-<nonce>``) and drops it
  only after the new one landed, and ``steps()`` recovers an orphaned
  ``.old-`` copy
- async: saves run on a background thread; ``wait()`` joins and raises
  what the thread raised
- retention: keeps the newest ``keep`` checkpoints, under a lock that
  readers hold too, so a retention delete never removes a step mid-read

Trees are nested dicts, lists or tuples whose leaves are tensors (on any
device), numpy arrays or scalars; a module's ``state_dict()`` is one.
``save`` copies every leaf to the host before the background thread
starts, so the caller may go on changing its tensors. The on-disk form is
the reference's: ``arrays.npz`` keyed by the leaf paths joined with
``"::"`` (dict keys, list indices), and ``manifest.json`` with the same
fields, so a checkpoint written by either package restores in the other.
Tensors whose type numpy lacks (bfloat16) are stored as float32 and cast
back to the ``like`` leaf's type on restore.

``restore(like, step, device)`` puts each array on ``device``, or on the
device of ``like``'s tensor leaf; numpy leaves come back as numpy. The
reference's ``shardings=`` (restore onto another mesh) and ``mode=
"sharded"`` come with the multi-GPU slice (ROADMAP module 8).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

Tree = Any
SEP = "::"
_MODULE_8 = "the multi-GPU slice (ROADMAP module 8)"


def _children(tree):
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten(tree: Tree, prefix: str = "") -> dict:
    """``{"a::0::w": leaf}`` for every leaf of ``tree``."""
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    out = {}
    for k, v in kids:
        out.update(_flatten(v, f"{prefix}{SEP}{k}" if prefix else k))
    return out


def _unflatten(like: Tree, leaves: dict, prefix: str = "") -> Tree:
    kids = _children(like)
    if kids is None:
        return leaves[prefix]
    built = [_unflatten(v, leaves, f"{prefix}{SEP}{k}" if prefix else k)
             for k, v in kids]
    if isinstance(like, dict):
        return type(like)(zip(like.keys(), built))
    return type(like)(built)


def tree_paths(tree: Tree) -> dict:
    return _flatten(tree)


def _to_host(leaf) -> np.ndarray:
    """An immutable host copy of ``leaf``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _like_leaf(arr: np.ndarray, ref, device):
    """``arr`` in the type and place of the ``like`` leaf ``ref``."""
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(arr).to(
            device if device is not None else ref.device, ref.dtype)
    if hasattr(ref, "dtype"):
        arr = arr.astype(ref.dtype)
    if device is not None:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return arr


class CheckpointManager:
    def __init__(self, directory, *, keep: int = 3, mode: str = "full",
                 async_save: bool = True):
        if mode != "full":
            raise NotImplementedError(
                f"CheckpointManager(mode={mode!r}): per-shard files come "
                f"with {_MODULE_8}; use mode='full'")
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.mode = mode
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # serializes retention deletes (the async save thread) against
        # readers (steps() / restore() on the caller's thread)
        self._lock = threading.Lock()

    # ---- save ------------------------------------------------------------
    def save(self, step: int, state: Tree, extra: Optional[dict] = None):
        host = {k: _to_host(v) for k, v in _flatten(state).items()}
        self.wait()

        def work():
            try:
                self._write(step, host, extra or {})
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self._raise_if_failed()

    def _write(self, step: int, host: dict, extra: dict):
        final = self.dir / f"step_{step:010d}"
        tmp = self.dir / f"step_{step:010d}.tmp-{uuid.uuid4().hex[:8]}"
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **host)
        manifest = {
            "step": step,
            "time": time.time(),
            "mode": self.mode,
            "n_arrays": len(host),
            "total_bytes": int(sum(a.nbytes for a in host.values())),
            "extra": extra,
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
        # a re-save never loses the step: the old directory is renamed
        # aside before the new one lands and deleted only after
        with self._lock:
            old = None
            if final.exists():
                old = self.dir / \
                    f"step_{step:010d}.old-{uuid.uuid4().hex[:8]}"
                os.replace(final, old)
            os.replace(tmp, final)
            if old is not None:
                shutil.rmtree(old, ignore_errors=True)
        self._gc(newest=step)

    def _gc(self, newest: Optional[int] = None):
        with self._lock:
            steps = sorted(self.steps_unlocked())
            for s in steps[: max(0, len(steps) - self.keep)]:
                # never the step just written: the caller may be about to
                # restore(latest_step()) it
                if newest is not None and s >= newest:
                    continue
                shutil.rmtree(self.dir / f"step_{s:010d}",
                              ignore_errors=True)
            for stale in self.dir.glob("step_*.tmp-*"):
                if time.time() - stale.stat().st_mtime > 3600:
                    shutil.rmtree(stale, ignore_errors=True)
            for stale in self.dir.glob("step_*.old-*"):
                # only superseded copies; an orphan is a crash survivor
                if (self.dir / stale.name.split(".old-")[0]).exists():
                    shutil.rmtree(stale, ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"async checkpoint save failed: {err!r}") from err

    # ---- restore -----------------------------------------------------------
    def steps_unlocked(self):
        # crash-window recovery: a re-save that died between renaming the
        # old step aside and landing the new one leaves an ``.old-``
        # orphan with no final directory; rename it back
        for p in self.dir.glob("step_*.old-*"):
            final = self.dir / p.name.split(".old-")[0]
            if not final.exists() and (p / "manifest.json").exists():
                os.replace(p, final)
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and p.name.split("_", 1)[1].isdigit() \
                    and (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def steps(self):
        with self._lock:
            return self.steps_unlocked()

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, like: Tree, step: Optional[int] = None,
                device=None, shardings=None) -> Tree:
        """Restore into the structure of ``like``: each array on
        ``device``, or on the device of ``like``'s tensor leaf, in that
        leaf's type. ``shardings`` (a restore onto several cards) raises:
        it comes with module 8."""
        if shardings is not None:
            raise NotImplementedError(
                f"restore(shardings=...): a restore onto several cards "
                f"comes with {_MODULE_8}")
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        flat_like = _flatten(like)
        leaves = {}
        # hold the retention lock for the whole read: npz members load
        # lazily, so the file must stay intact until the last array is out
        with self._lock:
            self.steps_unlocked()  # recover a crash-window .old- orphan
            with np.load(self.dir / f"step_{step:010d}"
                         / "arrays.npz") as data:
                for key, ref in flat_like.items():
                    if key not in data:
                        raise KeyError(f"checkpoint missing array {key!r}")
                    leaves[key] = _like_leaf(data[key], ref, device)
        return _unflatten(like, leaves)

    def manifest(self, step: Optional[int] = None) -> dict:
        step = step if step is not None else self.latest_step()
        return json.loads(
            (self.dir / f"step_{step:010d}" / "manifest.json").read_text())
