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
from repro_torch.optim.adamw import (_dequantize_blockwise,
                                     _quantize_blockwise)
from repro_torch.vision.dnn import FinalDNN


def _flat_raw(params, prefix=""):
    """A nested tree -> ``{"a/b": leaf}`` (a flat tree passes through)."""
    out = {}
    for k, v in params.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat_raw(v, key))
        else:
            out[key] = v
    return out


def _flat(params, prefix=""):
    """:func:`_flat_raw` with every leaf as fp32 numpy."""
    return {k: np.asarray(v, np.float32)
            for k, v in _flat_raw(params, prefix).items()}


def _is_quantized(v_tree) -> bool:
    """Whether an optimizer's second-moment tree is the int8 form."""
    return any(k.endswith("/q") or k == "q" for k in _flat_raw(v_tree))


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


def _port_named(cfg, flat: dict) -> dict:
    """The reference's flat ``"a/b"`` leaves -> the port's parameter names
    (``"a.b"``), a stacked subtree's leading block axis split across the
    per-block modules."""
    stacks = _stacks(cfg)
    out = {}
    for key, v in flat.items():
        head, _, rest = key.partition("/")
        if head not in stacks:
            out[key.replace("/", ".")] = v
            continue
        if v.shape[0] != cfg.n_blocks:
            raise ValueError(f"{key}: leading axis {v.shape[0]}, expected "
                             f"{cfg.n_blocks} blocks")
        for b in range(cfg.n_blocks):
            out[f"{stacks[head]}.{b}.{rest.replace('/', '.')}"] = v[b]
    return out


def _ref_key(cfg, name: str):
    """A port parameter name -> (the reference's flat key, the block index
    within its stacked subtree or None)."""
    for head, prefix in _stacks(cfg).items():
        if name.startswith(prefix + "."):
            b, rest = name[len(prefix) + 1:].split(".", 1)
            return f"{head}/{rest.replace('.', '/')}", int(b)
    return name.replace(".", "/"), None


def _ref_flat(cfg, named: dict) -> dict:
    """The inverse of :func:`_port_named`: port names -> the reference's
    flat keys, the per-block values of a stacked subtree stacked on a
    leading axis."""
    flat, blocks = {}, {}
    for name, v in named.items():
        key, b = _ref_key(cfg, name)
        if b is None:
            flat[key] = v
        else:
            blocks.setdefault(key, {})[b] = v
    for key, per_block in blocks.items():
        flat[key] = np.stack([per_block[b]
                              for b in range(len(per_block))])
    return flat


def lm_from_numpy(cfg, params, device="cuda", dtype=torch.float32):
    """A :class:`DecoderLM` (an :class:`EncDecLM` for an enc-dec ``cfg``)
    holding the reference's ``params`` (nested or flat ``"a/b"`` keys,
    numpy), with weights and compute in ``dtype`` (the parameters the
    reference keeps in fp32 stay fp32). Nothing is drawn: the strict load
    sets every parameter."""
    cls = EncDecLM if cfg.enc_dec else DecoderLM
    model = cls(cfg, compute_dtype=dtype, param_dtype=dtype, device=device,
                init=False)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           _port_named(cfg, _flat(params)).items()})
    return model


def _host(t) -> np.ndarray:
    """An fp32 host copy of ``t`` (never a view of a CPU tensor, which the
    optimizer updates in place)."""
    return np.array(t.detach().float().cpu())


def lm_to_numpy(model) -> dict:
    """``model``'s parameters (a :class:`DecoderLM` or an
    :class:`EncDecLM`) in the reference's flat form, fp32 copies, the
    blocks stacked on a leading axis."""
    return _ref_flat(model.cfg, {k: _host(t)
                                 for k, t in model.state_dict().items()})


def _q_leaves(tree, prefix="") -> dict:
    """The int8 second moment's tree -> {"a/b": {"q", "scale"}}."""
    if set(tree) == {"q", "scale"}:
        return {prefix: {t: np.asarray(tree[t]) for t in ("q", "scale")}}
    out = {}
    for k, v in tree.items():
        out.update(_q_leaves(v, f"{prefix}/{k}" if prefix else k))
    return out


def _requantized(q, scale, shape, split: bool):
    """An int8 moment over a reference leaf of ``shape`` as the port holds
    it: one ``{"q", "scale"}`` for the whole tensor, or with ``split`` one
    for each block of its leading axis, each quantized over its own
    values: within the int8 rounding, half a step of a block's scale.
    A zero moment (the reference's initial state) stays zero (``q`` 0,
    the scale at its floor 1e-12 where the reference holds 0)."""
    as_t = {"q": torch.from_numpy(np.array(q)),
            "scale": torch.from_numpy(np.array(scale))}
    if not split:
        return as_t
    full = _dequantize_blockwise(as_t["q"], as_t["scale"], shape)
    return [dict(zip(("q", "scale"), _quantize_blockwise(full[b])))
            for b in range(shape[0])]


def train_state_from_numpy(cfg, state, device="cuda",
                           dtype=torch.float32):
    """The reference's train state ``{"params", "opt": {"m", "v",
    "count"}, "step"}`` (numpy leaves) -> (the model, the port's train
    state as ``train.steps.init_train_state`` makes it, holding the same
    values), on ``device`` (default CUDA, which raises where there is
    none). The moments keep their type (fp32 or bf16); an int8 ``v``
    (``{"q", "scale"}`` per tensor) is requantized per block over the
    stacked tensors (see :func:`_requantized`)."""
    model = lm_from_numpy(cfg, state["params"], device, dtype)
    dev = model.device
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    ref_m = state["opt"]["m"]
    first = np.asarray(next(iter(_flat_raw(ref_m).values())))
    m_dtype = torch.bfloat16 if str(first.dtype) == "bfloat16" \
        else torch.float32

    def moments(tree):
        return {k: torch.from_numpy(np.array(a)).to(dev, m_dtype)
                for k, a in _port_named(cfg, _flat(tree)).items()}

    ref_v = state["opt"]["v"]
    if _is_quantized(ref_v):
        shapes = {k: v.shape for k, v in _flat(state["params"]).items()}
        stacks = _stacks(cfg)
        v = {}
        for key, qs in _q_leaves(ref_v).items():
            head, _, rest = key.partition("/")
            got = _requantized(qs["q"], qs["scale"], shapes[key],
                               head in stacks)
            if head not in stacks:
                v[key.replace("/", ".")] = got
                continue
            for b, x in enumerate(got):
                v[f"{stacks[head]}.{b}.{rest.replace('/', '.')}"] = x
        v = {n: {t: a.to(dev) for t, a in x.items()} for n, x in v.items()}
    else:
        v = moments(ref_v)
    m = moments(ref_m)
    as_int = {k: torch.as_tensor(np.array(x), dtype=torch.int32,
                                 device=dev)
              for k, x in (("count", state["opt"]["count"]),
                           ("step", state["step"]))}
    return model, {"params": params,
                   "opt": {"m": {n: m[n] for n in params},
                           "v": {n: v[n] for n in params},
                           "count": as_int["count"]},
                   "step": as_int["step"]}


def train_state_to_numpy(model, state) -> dict:
    """The port's train state in the reference's flat form: ``{"params":
    {"a/b": fp32}, "opt": {"m": {...}, "v": {...} (or {"a/b": {"q",
    "scale"}}), "count": int32}, "step": int32}``, the blocks stacked (an
    int8 ``v`` requantized over the stacked tensor, see
    :func:`_requantized`)."""
    cfg = model.cfg
    params = dict(model.named_parameters())

    v = state["opt"]["v"]
    if any(isinstance(x, dict) for x in v.values()):
        v_np, blocks = {}, {}
        for n, x in v.items():
            key, b = _ref_key(cfg, n)
            if b is None:
                v_np[key] = {t: np.array(x[t].cpu()) for t in ("q", "scale")}
            else:
                blocks.setdefault(key, {})[b] = _dequantize_blockwise(
                    x["q"].cpu(), x["scale"].cpu(), tuple(params[n].shape))
        for key, per_block in blocks.items():
            q, sc = _quantize_blockwise(torch.stack(
                [per_block[b] for b in range(len(per_block))]))
            v_np[key] = {"q": q.numpy(), "scale": sc.numpy()}
    else:
        v_np = _ref_flat(cfg, {n: _host(x) for n, x in v.items()})
    return {"params": lm_to_numpy(model),
            "opt": {"m": _ref_flat(cfg, {n: _host(x) for n, x in
                                          state["opt"]["m"].items()}),
                    "v": v_np,
                    "count": np.array(state["opt"]["count"].cpu(),
                                      np.int32)},
            "step": np.array(state["step"].cpu(), np.int32)}
