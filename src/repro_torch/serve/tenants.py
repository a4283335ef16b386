"""Multi-tenant serving specs: one fleet, many server DNNs (port of
``repro.serve.tenants``).

AccMPEG's onboarding story (PAPER.md §4) is "given a new server-side
DNN, quickly create a cheap model to infer its accuracy gradient":

- :class:`TenantSpec` bundles what one tenant brings to a shared fleet:
  its server DNN (a port ``FinalDNN``), the ``AccModel`` calibrated
  against it, its ``QualityConfig`` (keypoint tenants run QP (30, 51) per
  §6.1 where detection runs (30, 40)) and its SLO tier ladder.
- :func:`calibrate_tenant` is the repeatable onboarding step: it wraps
  ``core.training.train_accmodel`` (seeded, so the result is a function
  of its inputs) and caches the trained AccModel per *spec hash* through
  ``checkpoint.manager.CheckpointManager``: onboarding the same DNN on
  the same clips again is a restore, not a training run.

The engine takes tenants through ``engine.EngineConfig(tenants=,
tenant_of=)``; the tenant-routed fleet steps are in ``serve.steps``.
:func:`stack_trees` / :func:`gather_tree` keep the reference's stacked
parameter layout over state dicts; the port's steps group lanes by
tenant instead (see ``serve.steps``), so they do not need it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.accmodel import AccModel
from repro_torch.core.aggregate import DEFAULT_TIERS, SLOTier
from repro_torch.core.quality import QualityConfig
from repro_torch.vision.dnn import _np

#: output keys each task's server net contributes to the union output
#: dict of the tenant server step (detection's ``keep`` is the NMS half
#: of decoding, computed in the step)
TASK_KEYS = {
    "detection": ("heat", "wh", "off", "keep"),
    "segmentation": ("seg",),
    "keypoint": ("kp",),
}


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant of a shared serving fleet.

    ``dnn`` is the tenant's server-side ``repro_torch.vision.dnn.FinalDNN``
    and ``accmodel`` the camera-side selector calibrated against it
    (:func:`calibrate_tenant`). ``qcfg`` is the tenant's quality config;
    ``tiers`` its SLO ladder (per-tenant attainment is kept against it in
    ``core.aggregate``). ``name`` labels telemetry gauges."""

    name: str
    dnn: object          # vision.dnn.FinalDNN
    accmodel: AccModel
    qcfg: QualityConfig = QualityConfig()
    tiers: Tuple[SLOTier, ...] = DEFAULT_TIERS

    def __post_init__(self):
        object.__setattr__(self, "tiers", tuple(self.tiers))
        if not self.tiers:
            raise ValueError(f"tenant {self.name!r} needs at least one "
                             f"SLO tier")
        if self.task not in TASK_KEYS:
            raise ValueError(f"tenant {self.name!r} serves unknown task "
                             f"{self.task!r}; known: "
                             f"{sorted(TASK_KEYS)}")

    @property
    def task(self) -> str:
        return self.dnn.task


def _state_bytes(state: dict) -> bytes:
    """Deterministic digest of a state dict (sorted names, then each
    tensor's shape, type and raw bytes): the spec hash's view of 'the
    same DNN'."""
    h = hashlib.sha256()
    for name in sorted(state):
        arr = np.ascontiguousarray(_np(state[name]))
        h.update(name.encode())
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.digest()


def tenant_spec_hash(dnn, frames, hyper: dict) -> str:
    """Content hash of one calibration job: the server DNN's identity
    (task and parameters), the training clips, and every hyperparameter
    that changes the trained AccModel. Two calls agree iff the seeded
    training run would give the same model. (Not the reference's digest:
    the two packages name and lay out parameters differently.)"""
    h = hashlib.sha256()
    h.update(dnn.task.encode())
    h.update(_state_bytes(dnn.state_dict()))
    frames = np.ascontiguousarray(_np(frames))
    h.update(str(frames.shape).encode())
    h.update(str(frames.dtype).encode())
    h.update(frames.tobytes())
    h.update(json.dumps(hyper, sort_keys=True).encode())
    return h.hexdigest()


def calibrate_tenant(name: str, dnn, frames, *,
                     qcfg: QualityConfig = QualityConfig(),
                     tiers: Sequence[SLOTier] = DEFAULT_TIERS,
                     qp_hi: int = 30, qp_lo: int = 40, epochs: int = 15,
                     batch: int = 4, width: int = 16, seed: int = 0,
                     pos_weight: float = 4.0, label_alpha: float = 0.1,
                     cache_dir=None) -> TenantSpec:
    """Onboard a new server DNN as a fleet tenant.

    Trains the tenant's AccModel with ``core.training.train_accmodel`` on
    the DNN's device (seeded: the result is a function of the DNN, the
    clips and the hyperparameters) and returns the :class:`TenantSpec`.
    With ``cache_dir`` set, the trained weights are cached per spec hash
    through :class:`~repro_torch.checkpoint.manager.CheckpointManager`
    (``<cache_dir>/tenant_<hash[:16]>``, the AccModel's state dict):
    onboarding the same spec again restores instead of training."""
    from repro_torch.core import training

    hyper = {"qp_hi": int(qp_hi), "qp_lo": int(qp_lo),
             "epochs": int(epochs), "batch": int(batch),
             "width": int(width), "seed": int(seed),
             "pos_weight": float(pos_weight),
             "label_alpha": float(label_alpha)}
    label = f"accmodel[{name}]"
    mgr = None
    if cache_dir is not None:
        from repro_torch.checkpoint.manager import CheckpointManager

        spec = tenant_spec_hash(dnn, frames, hyper)
        mgr = CheckpointManager(Path(cache_dir) / f"tenant_{spec[:16]}",
                                async_save=False)
        if mgr.steps():
            step = mgr.latest_step()
            if mgr.manifest(step)["extra"].get("spec_hash") == spec:
                model = training.accmodel_init(seed, width, dnn.device)
                model.load_state_dict(mgr.restore(model.state_dict(),
                                                  step=step))
                model.name = label
                return TenantSpec(name=name, dnn=dnn, accmodel=model,
                                  qcfg=qcfg, tiers=tuple(tiers))
    rep = training.train_accmodel(dnn, frames, qp_hi=qp_hi, qp_lo=qp_lo,
                                  epochs=epochs, batch=batch, width=width,
                                  seed=seed, pos_weight=pos_weight,
                                  label_alpha=label_alpha)
    model = rep.accmodel
    model.name = label
    if mgr is not None:
        mgr.save(0, model.state_dict(), extra={"spec_hash": spec,
                                               "tenant": name})
    return TenantSpec(name=name, dnn=dnn, accmodel=model, qcfg=qcfg,
                      tiers=tuple(tiers))


# ---------------------------------------------------------------------------
# the reference's stacked-parameter layout, over state dicts
# ---------------------------------------------------------------------------
def stack_trees(trees: Sequence[dict]) -> dict:
    """Stack per-tenant state dicts name by name into one dict of (T, ...)
    tensors. Raises when the dicts differ in names or shapes (tenants on
    one stack must share the network's geometry)."""
    first = list(trees[0])
    for i, t in enumerate(trees[1:], start=1):
        if list(t) != first:
            raise ValueError(
                f"tenant {i}'s param tree structure differs from tenant "
                f"0's; stacked routed dispatch needs identical trees")
    shapes = [tuple(tuple(t[k].shape) for k in first) for t in trees]
    if any(s != shapes[0] for s in shapes[1:]):
        raise ValueError(
            "tenant param leaf shapes differ across tenants; stacked "
            "routed dispatch needs a shared network geometry (same "
            "width) — onboard the tenants at one width or serve them "
            "on dedicated engines")
    return {k: torch.stack([torch.as_tensor(t[k]) for t in trees])
            for k in first}


def gather_tree(stacked: dict, idx) -> dict:
    """Tenant ``idx``'s state dict out of a :func:`stack_trees` stack."""
    return {k: v[idx] for k, v in stacked.items()}


def validate_tenants(tenants: Sequence[TenantSpec], impl: str = "fast"):
    """Fleet-level checks, raised at engine build:

    - at least one tenant; unique names;
    - ``gamma`` agrees across tenants (one dilation window for the
      fleet's camera step);
    - the chunk-fused backends (``fused`` / ``fused_exact``) need one
      shared quality config: the scores kernel takes a single fleet-wide
      (alpha, qp_hi, qp_lo) triple.
    """
    tenants = tuple(tenants)
    if not tenants:
        raise ValueError("a tenanted engine needs at least one TenantSpec")
    names = [t.name for t in tenants]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tenant names: {names}")
    gammas = {t.qcfg.gamma for t in tenants}
    if len(gammas) > 1:
        raise ValueError(
            f"tenants disagree on qcfg.gamma ({sorted(gammas)}): the "
            f"dilation window is a static shape in the fused camera "
            f"program, so every tenant of one fleet must share it")
    if impl in ("fused", "fused_exact"):
        qcfgs = {t.qcfg for t in tenants}
        if len(qcfgs) > 1:
            raise ValueError(
                f"impl={impl!r} fuses one fleet-wide (alpha, qp_hi, "
                f"qp_lo) triple into the chunk kernel; tenants with "
                f"heterogeneous QualityConfigs need impl='fast' or "
                f"'exact'")
    return tenants
