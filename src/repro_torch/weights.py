"""Carry the reference package's weights into the port's modules, and
back.

The reference keeps parameters as nested dicts ``{"backbone": {"b1":
{"dw": {"w": HWIO, "b": (co,)}}}}``, saved flat as ``"backbone/b1/dw/w"``
(``repro.vision.train._flatten``). Either form, as numpy arrays, loads
here: HWIO weights become OIHW (a depthwise ``(3, 3, 1, ci)`` becomes
``(ci, 1, 3, 3)``), and the module names match the tree's keys. The two
packages draw different random numbers from a seed, so shared weights
come across this way rather than by re-initialising. The inverse
(:func:`final_dnn_to_numpy`, :func:`accmodel_to_numpy`) gives the flat form
back, OIHW turned into HWIO, so that the port's trained weights compare
with the reference's and save as its npz.

The LM's tree (``embed``, ``blocks``, ``final_norm``, ``lm_head``) maps
key for key onto :class:`DecoderLM`'s modules, Linear weights staying in
the reference's (d_in, d_out) layout; ``blocks`` carries a leading
n_blocks axis, which is split across the port's per-block modules
(:func:`lm_from_numpy`) and stacked back (:func:`lm_to_numpy`). An
encoder-decoder's tree (``embed``, ``encoder``, ``decoder``,
``enc_norm``, ``final_norm``, ``lm_head``) maps onto :class:`EncDecLM`
alike, ``encoder`` and ``decoder`` each stacked over the blocks.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.accmodel import AccModel
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import DecoderLM
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


def flat_numpy(named) -> dict:
    """The flat ``"a/b/w"`` form of PyTorch-named tensors (a state dict,
    or parameter gradients under their parameters' names): OIHW weights
    as HWIO, biases as they are."""
    flat = {}
    for key, t in named.items():
        *path, leaf = key.split(".")
        v = t.detach().cpu().numpy()
        if leaf == "weight":
            flat["/".join(path + ["w"])] = v.transpose(2, 3, 1, 0).copy()
        elif leaf == "bias":
            flat["/".join(path + ["b"])] = v.copy()
        else:
            raise ValueError(f"unexpected parameter {key!r}")
    return flat


def final_dnn_to_numpy(net: FinalDNN) -> dict:
    """``net``'s weights in the reference's flat npz form."""
    return flat_numpy(net.state_dict())


def accmodel_to_numpy(model: AccModel) -> dict:
    """``model``'s weights in the reference's flat npz form."""
    return flat_numpy(model.state_dict())


def _stacks(cfg) -> dict:
    """The reference tree's block-stacked subtrees of an LM of ``cfg``,
    each with the port's prefix for its per-block modules."""
    if cfg.enc_dec:
        return {"encoder": "encoder.blocks", "decoder": "decoder.blocks"}
    return {"blocks": "stack.blocks"}


def lm_from_numpy(cfg, params, device="cuda", dtype=torch.float32):
    """A :class:`DecoderLM` (an :class:`EncDecLM` for an enc-dec ``cfg``)
    holding the reference's ``params`` (nested or flat ``"a/b"`` keys,
    numpy), with weights and compute in ``dtype`` (the parameters the
    reference keeps in fp32 stay fp32). Nothing is drawn: the strict load
    sets every parameter."""
    cls = EncDecLM if cfg.enc_dec else DecoderLM
    model = cls(cfg, compute_dtype=dtype, param_dtype=dtype, device=device,
                init=False)
    stacks = _stacks(cfg)
    sd = {}
    for key, v in _flat(params).items():
        head, _, rest = key.partition("/")
        if head not in stacks:
            sd[key.replace("/", ".")] = torch.from_numpy(v.copy())
            continue
        if v.shape[0] != cfg.n_blocks:
            raise ValueError(f"{key}: leading axis {v.shape[0]}, expected "
                             f"{cfg.n_blocks} blocks")
        for b in range(cfg.n_blocks):
            sd[f"{stacks[head]}.{b}.{rest.replace('/', '.')}"] = \
                torch.from_numpy(v[b].copy())
    model.load_state_dict(sd)
    return model


def lm_to_numpy(model) -> dict:
    """``model``'s parameters (a :class:`DecoderLM` or an
    :class:`EncDecLM`) in the reference's flat form, fp32, the blocks
    stacked on a leading axis."""
    prefixes = {p + ".": head for head, p in _stacks(model.cfg).items()}
    flat, blocks = {}, {}
    for key, t in model.state_dict().items():
        v = t.detach().float().cpu().numpy()
        pre = next((p for p in prefixes if key.startswith(p)), None)
        if pre is None:
            flat[key.replace(".", "/")] = v
            continue
        b, rest = key[len(pre):].split(".", 1)
        blocks.setdefault(f"{prefixes[pre]}/{rest}", {})[int(b)] = v
    for name, per_block in blocks.items():
        flat[name.replace(".", "/")] = np.stack(
            [per_block[b] for b in range(len(per_block))])
    return flat
