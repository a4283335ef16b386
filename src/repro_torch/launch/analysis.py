"""Counting one step of the port on meta tensors (the counterpart of
``repro.launch.hlo_analysis``).

The reference compiles each step to HLO and walks its computations,
multiplying loop bodies by their trip counts. The port runs eagerly, so
its loops reach the dispatcher once a pass. :func:`analyze` runs a step
once on ``torch.device("meta")`` (shapes only: nothing is allocated and
no kernel is built or launched, see :mod:`repro_torch.kernels`) under a
dispatch mode that counts, op by op:

- ``dot_flops``: the matrix-product FLOPs of ``torch.utils.
  flop_counter``'s formulas (mm, addmm, bmm, baddbmm, convolutions,
  attention), exactly what ``FlopCounterMode`` counts on the same step; a
  hand-written kernel counts as its plain version, whose products are
  those formulas' ops;
- ``other_flops``: one per output element of every other op that moves
  data, as the reference counts its non-dot ops;
- ``hbm_bytes``: each such op's input and output bytes. Eager PyTorch
  fuses nothing, so every op reads its inputs from and writes its outputs
  to device memory: an upper bound of a fused program's traffic. Views
  move nothing and count nothing;
- ``peak_live_bytes``: the largest sum of the bytes of the storages alive
  at once over the pass, counting those alive when it starts (``roots``:
  the weights, the inputs, a train state);
- ``collective_wire_bytes``: 0, on one card.

Two kinds of loop are counted by their trip counts instead of pass by
pass, as the reference counts a loop body:

- a sequence's chunks and a scan's positions, written with
  :func:`repro_torch.loop`: under the count such a loop runs three passes
  and counts the middle one for all but the first and the last
  (:meth:`_Counter.repeated`);
- a cell's super-blocks and a train step's micro-batches:
  :func:`count_cell` counts the step of a prefix of one and two blocks
  (and of two and three micro-batches) and extrapolates, the step's cost
  being affine in each.

:func:`roofline_terms` turns the counts into the reference's three terms
at the card's rates.
"""
from __future__ import annotations

import collections
import itertools
import re
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.nn.modules.module import (register_module_forward_hook,
                                     register_module_forward_pre_hook)
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import COUNTING, _loop

# NVIDIA H100 80GB HBM3 (SXM5, 700.00 W power limit), from NVIDIA's H100
# Tensor Core GPU data sheet: dense BF16 tensor-core peak, HBM3 bandwidth,
# NVLink bandwidth; and its memory as torch.cuda.get_device_properties
# reports it on that card (launch.dryrun's records, --device cuda)
H100_BF16_FLOP_PER_S = 989.4e12
H100_HBM_BYTES_PER_S = 3.35e12
H100_NVLINK_BYTES_PER_S = 900e9
H100_MEMORY_BYTES = 85_017_493_504
CARD_NAME = "NVIDIA H100 80GB HBM3"
META = torch.device("meta")

# ops that ask about a tensor's layout and compute nothing
_METADATA = {torch.ops.aten.is_contiguous.default,
             torch.ops.aten.is_contiguous.memory_format,
             torch.ops.aten.is_strides_like_format.default,
             torch.ops.aten.is_non_overlapping_and_dense.default,
             torch.ops.aten.size.default, torch.ops.aten.sym_size.default,
             torch.ops.aten.stride.default,
             torch.ops.aten.sym_stride.default,
             torch.ops.aten.storage_offset.default,
             torch.ops.aten.sym_storage_offset.default,
             torch.ops.aten.numel.default, torch.ops.aten.sym_numel.default,
             torch.ops.aten.dim.default, torch.ops.prim.layout.default,
             torch.ops.prim.device.default}
# views the schema does not mark as views: they move nothing either
_VIEWS = {torch.ops.aten._unsafe_view.default}
_BLOCK = re.compile(r"\.blocks\.\d+")


class _Modules:
    """The path of the module whose forward is running (the innermost),
    from forward hooks on every module: ``Stack.blocks.*.sub0.ffn``, the
    outermost module by its class name and the others by their attribute
    names. ``torch.utils.module_tracker.ModuleTracker`` also hooks the
    backward, and its hooks keep a checkpointed block's recomputed
    tensors alive: they would count in the peak."""

    def __init__(self):
        self.stack = []
        self._names = {}  # id(module) -> its path
        self._handles = ()

    def _pre(self, module, args):
        if id(module) not in self._names:  # it and what it holds
            top = type(module).__name__
            for name, sub in module.named_modules():
                self._names.setdefault(id(sub),
                                       f"{top}.{name}" if name else top)
        self.stack.append(_BLOCK.sub(".blocks.*", self._names[id(module)]))

    def _post(self, module, args, out):
        self.stack.pop()

    def path(self) -> str:
        """Where the running op runs: the innermost module, or in a
        backward pass the autograd node it runs for."""
        node = torch._C._current_autograd_node()
        if node is not None and not self.stack:
            return f"{node.name()} (backward)"
        return self.stack[-1] if self.stack else "Global"

    def __enter__(self):
        self._handles = (register_module_forward_pre_hook(self._pre),
                         register_module_forward_hook(self._post))
        return self

    def __exit__(self, *exc):
        for handle in self._handles:
            handle.remove()


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter(TorchDispatchMode):
    """The counts of :func:`analyze`, op by op; ``tracker`` names the
    module each op runs in (the innermost).

    A loop of ``n`` passes written with :func:`repro_torch.loop` runs
    three (:meth:`repeated`): the first, the second and the last. The
    second pass's ops count ``n - 2`` times, and so do the backward ops of
    the autograd nodes it made (known by their sequence numbers, which
    grow in the order nodes are made). What that pass leaves alive, its
    carried state aside, is held ``n - 2`` times over, as those passes
    would leave it."""

    def __init__(self, tracker: _Modules):
        super().__init__()
        self.tracker = tracker
        self.dot_flops = self.other_flops = self.hbm_bytes = 0
        self.n_ops = 0
        self.live = self.peak = 0
        self.scale = 1  # the trip counts of the loops being run
        self.regions = []  # (first, last sequence number, trip count)
        self._born = None  # storages made in the loop pass being run
        self._quiet = False
        self._weights = WeakIdKeyDictionary()  # storage -> [bytes held]
        # (aten op, module path) -> [FLOPs, bytes, calls]
        self.rows = collections.defaultdict(lambda: [0, 0, 0])

    def hold(self, t: torch.Tensor):
        """Count ``t``'s storage as alive until it is freed."""
        st = t.untyped_storage()
        if st in self._weights:
            return
        weight = [st.nbytes()]
        self._weights[st] = weight
        weakref.finalize(st, self._free, weight)
        if self._born is not None:
            self._born.append(weakref.ref(st))
        self._add(weight[0])

    def _add(self, n: int):
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, weight):
        self.live -= weight[0]

    def _seq(self):
        """The sequence number of an autograd node made now (None where
        autograd records nothing)."""
        if not torch.is_grad_enabled():
            return None
        self._quiet = True
        try:
            probe = torch.empty((), device=META, requires_grad=True) * 1
            return probe.grad_fn._sequence_nr()
        finally:
            self._quiet = False

    def repeated(self, body, items, carry):
        """``repro_torch.loop`` under the count: the first pass, one middle
        pass counted ``n - 2`` times, and the last. The three differ in a
        backward pass: the first one's carried input is the loop's, the
        last one's carried output gets no gradient."""
        n = len(items)
        if n <= 3:
            return _loop(body, items, carry)
        first, carry = body(items[0], carry)
        middle, carry = self._counted(body, items[1], carry, n - 2)
        last, carry = body(items[-1], carry)
        fill = [middle] * (n - 3)
        if isinstance(middle, torch.Tensor) and middle.requires_grad:
            # the passes' outputs as one tensor without a gradient, so that
            # no gradient is summed into the counted pass's n - 2 times
            # over (its bytes are already held n - 2 times)
            self._quiet = True
            try:
                fill = [torch.empty_like(middle)] * (n - 3)
            finally:
                self._quiet = False
            self._weights[fill[0].untyped_storage()] = [0]
        return [first, middle] + fill + [last], carry

    def _counted(self, body, item, carry, n):
        """One pass of a loop body, counted ``n`` times."""
        lo = self._seq()
        outer, self._born = self._born, []
        peak_before, self.peak = self.peak, self.live
        self.scale *= n
        try:
            out, carry = body(item, carry)
        finally:
            self.scale //= n
            born, self._born = self._born, outer
        hi = self._seq()
        if lo is not None:
            self.regions.append((lo, hi, n))
        # the pass's own peak above what it left alive, which the last of
        # n passes reaches on top of the n - 1 before it
        transient = self.peak - self.live
        carried = {id(t.untyped_storage()) for t in _tensors(carry)}
        for ref in born:
            st = ref()
            if st is None or id(st) in carried:
                continue
            weight = self._weights[st]
            self._add((n - 1) * weight[0])
            weight[0] *= n
        self.peak = max(peak_before, self.peak, self.live + transient)
        if outer is not None:
            outer.extend(born)
        return out, carry

    def _scale(self) -> int:
        """The times the running op counts: the loops it runs in, and in
        a backward pass those whose pass made the node it runs for."""
        node = torch._C._current_autograd_node()
        if node is None:
            return self.scale
        seq = node._sequence_nr()
        scale = self.scale
        for lo, hi, n in self.regions:
            if lo < seq < hi:
                scale *= n
        return scale


    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA or self._quiet:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry:
            # as FlopCounterMode: an op without a formula counts as the ops
            # it decomposes into, where it has a decomposition
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        ins = _tensors((args, kwargs))
        for t in ins:  # alive before this op: made outside the pass
            self.hold(t)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self.hold(t)
        if func.is_view or func in _VIEWS:
            return out
        scale = self._scale()
        if packet in flop_registry:
            flops = scale * flop_registry[packet](*args, **kwargs,
                                                  out_val=out)
            self.dot_flops += flops
        else:
            flops = scale * sum(t.numel() for t in outs)
            self.other_flops += flops
        moved = scale * (sum(_bytes(t) for t in ins)
                         + sum(_bytes(t) for t in outs))
        self.hbm_bytes += moved
        self.n_ops += scale
        row = self.rows[(str(packet), self.tracker.path())]
        row[0] += flops
        row[1] += moved
        row[2] += scale
        return out


def analyze(fn, *args, roots=(), **kwargs):
    """Run ``fn(*args, **kwargs)`` once under the counting mode -> (its
    result, the analysis: ``dot_flops``, ``other_flops``, ``flops``,
    ``hbm_bytes``, ``peak_live_bytes``, ``collective_bytes`` ({}),
    ``collective_wire_bytes`` (0.0), ``n_ops``, and ``rows``: (FLOPs,
    bytes, calls) by (aten op, module path), for
    :mod:`repro_torch.launch.contrib`).

    ``roots``: tensors (or trees of them) alive as the step starts whose
    bytes belong to its peak (the model's parameters and buffers, a train
    state); the arguments' tensors count too. Every tensor must be on
    meta: the loops of :func:`repro_torch.loop` run only some of their
    passes under the count, so what the step returns stands for shapes,
    not values."""
    for t in _tensors((roots, args, kwargs)):
        if t.device != META:
            raise ValueError(f"analyze counts a step on meta tensors; got "
                             f"a tensor on {t.device}")
    tracker = _Modules()
    counter = _Counter(tracker)
    COUNTING.append(counter)
    try:
        with tracker, counter:
            for t in _tensors((roots, args, kwargs)):
                counter.hold(t)
            out = fn(*args, **kwargs)
    finally:
        COUNTING.remove(counter)
    return out, {
        "dot_flops": counter.dot_flops,
        "other_flops": counter.other_flops,
        "flops": counter.dot_flops + counter.other_flops,
        "hbm_bytes": counter.hbm_bytes,
        "peak_live_bytes": counter.peak,
        "collective_bytes": {},
        "collective_wire_bytes": 0.0,
        "n_ops": counter.n_ops,
        "rows": {k: tuple(v) for k, v in counter.rows.items()},
    }


# the first of the two trip counts that count_cell counts a loop at: one
# super-block; two micro-batches (a step of one takes another path, with
# no sum of the micro-batches' gradients)
_FIRST_PROBE = {"blocks": 2, "micro_batches": 2}


def _probes(n: int, first: int) -> tuple:
    """(trip count, weight) pairs whose weighted sum of counts is the
    count at ``n`` passes, for a count affine in ``n``: ``n`` itself where
    it is at most ``first + 1``, else ``first`` and ``first + 1``."""
    if n <= first + 1:
        return ((n, 1),)
    return ((first, first + 1 - n), (first + 1, n - first))


def _add(total, weight: int, value):
    """``total + weight * value`` over numbers and the dicts and tuples of
    them (``total`` None as zero; a key missing from ``total`` too)."""
    if isinstance(value, dict):
        total = dict(total or {})
        for k, v in value.items():
            total[k] = _add(total.get(k), weight, v)
        return total
    if isinstance(value, tuple):
        return tuple(_add(t, weight, v) for t, v in
                     zip(total or (None,) * len(value), value))
    return (total or 0) + weight * value


def _nbytes(tree) -> int:
    return sum(_bytes(t) for t in _tensors(tree))


def count_cell(arch: str, shape_name: str, cfg=None,
               mesh: str = "single") -> dict:
    """Count one dry-run cell's step (:func:`repro_torch.launch.specs.
    build_cell`, on meta tensors) -> ``{"analysis": as analyze's,
    "param_bytes", "opt_state_bytes" (train) or "cache_bytes" (the cache
    a prefill writes or a decode step reads), "param_count" (the model's
    parameters), "meta": the cell's, "probes": the (blocks,
    micro-batches) counted, with their weights}``.

    A step runs its super-blocks one after another, each alike, and a
    train step its micro-batches one after another through all of them:
    every count (FLOPs, bytes, ops; the weights, states and caches; the
    peak, reached in the last block of a micro-batch or after them with
    all of them alive) is ``a + b n + c g + d n g`` in ``n`` blocks and
    ``g`` micro-batches. So the step is counted at ``n`` in {1, 2} and
    ``g`` in {2, 3}, and the counts are extrapolated to the cell's: a
    cell of 80 layers costs the host what one of 3 does. A trip count no
    larger than its second probe is counted as it is."""
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.launch.specs import build_cell, train_micro_batches

    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    full = {"blocks": cfg.n_blocks}
    if shape.kind == "train":
        full["micro_batches"] = train_micro_batches(cfg, shape)
    axes = [_probes(n, _FIRST_PROBE[name]) for name, n in full.items()]
    total, probes = None, []
    for corner in itertools.product(*axes):
        sizes = {name: n for name, (n, _) in zip(full, corner)}
        weight = 1
        for _, w in corner:
            weight *= w
        cell = build_cell(arch, shape_name, cfg=cfg, mesh=mesh, **sizes)
        out, ana = analyze(cell.fn, *cell.args, roots=cell.roots)
        numbers = {"analysis": ana, "param_bytes": _nbytes(cell.roots),
                   "param_count": sum(p.numel()
                                      for p in cell.model.parameters())}
        if shape.kind == "train":
            numbers["opt_state_bytes"] = _nbytes(cell.args[0]["opt"])
        else:  # the cache a prefill writes, or a decode step reads
            numbers["cache_bytes"] = _nbytes(
                out[0] if shape.kind == "prefill" else cell.args[0])
        meta = cell.meta
        del out, cell
        total = _add(total, weight, numbers)
        probes.append(dict(sizes, weight=weight))
    meta = dict(meta, blocks=full["blocks"])
    if shape.kind == "train":
        meta["grad_accum"] = full["micro_batches"]
    return dict(total, meta=meta, probes=probes)


def roofline_terms(analysis: dict, *, peak_flops=H100_BF16_FLOP_PER_S,
                   hbm_bw=H100_HBM_BYTES_PER_S,
                   ici_bw=H100_NVLINK_BYTES_PER_S) -> dict:
    """Three roofline terms in seconds + the bottleneck, at the card's
    dense bf16 rate, HBM3 bandwidth and NVLink bandwidth (the keys of
    the reference's)."""
    t_compute = analysis["dot_flops"] / peak_flops
    t_memory = analysis["hbm_bytes"] / hbm_bw
    t_coll = analysis["collective_wire_bytes"] / ici_bw
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k]).replace("_s", "")
    terms["step_time_lower_bound_s"] = max(t_compute, t_memory, t_coll)
    return terms
