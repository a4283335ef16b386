"""Carry the reference package's weights into the port's modules.

The reference keeps parameters as nested dicts ``{"backbone": {"b1":
{"dw": {"w": HWIO, "b": (co,)}}}}``, saved flat as ``"backbone/b1/dw/w"``
(``repro.vision.train._flatten``). Either form, as numpy arrays, loads
here: HWIO weights become OIHW (a depthwise ``(3, 3, 1, ci)`` becomes
``(ci, 1, 3, 3)``), and the module names match the tree's keys. The two
packages draw different random numbers from a seed, so shared weights
come across this way rather than by re-initialising.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.accmodel import AccModel
from repro_torch.vision.dnn import FinalDNN


def _flat(params, prefix=""):
    out = {}
    for k, v in params.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v, np.float32)
    return out


def _state_dict(params) -> dict:
    sd = {}
    for key, v in _flat(params).items():
        *path, leaf = key.split("/")
        if leaf == "w":
            sd[".".join(path + ["weight"])] = \
                torch.from_numpy(v.transpose(3, 2, 0, 1).copy())
        elif leaf == "b":
            sd[".".join(path + ["bias"])] = torch.from_numpy(v.copy())
        else:
            raise ValueError(f"unexpected parameter {key!r}")
    return sd


def final_dnn_from_numpy(task: str, params, device="cuda",
                         name: str = "final-dnn") -> FinalDNN:
    """A :class:`FinalDNN` holding the reference's ``params`` for ``task``
    (width read from the stem, which has width/2 output channels)."""
    sd = _state_dict(params)
    width = 2 * sd["backbone.stem.weight"].shape[0]
    net = FinalDNN(task, width, device=device, name=name)
    net.load_state_dict(sd)
    return net


def accmodel_from_numpy(params, device="cuda",
                        name: str = "accmodel") -> AccModel:
    """An :class:`AccModel` holding the reference's ``params``."""
    sd = _state_dict(params)
    model = AccModel(sd["stem.weight"].shape[0], device=device, name=name)
    model.load_state_dict(sd)
    return model
