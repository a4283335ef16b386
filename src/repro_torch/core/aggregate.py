"""Streaming fleet aggregation: O(window) summaries instead of
O(streams x chunks) result lists.

A copy of ``repro.core.aggregate`` (numpy only, the same seeded reservoir
RNG), so that the port needs nothing of ``repro`` and its windowed results
equal the reference's bit for bit.

``MultiStreamEngine`` historically appended one :class:`ChunkResult` per
served stream-chunk into per-stream Python lists and computed fleet
metrics (accuracy means, pooled delay percentiles) over the full cross
product at the end. That accounting is exact but its host cost — and the
cross-host wire payload — grows as O(streams x chunks), which dominates
wall-clock long before the ROADMAP's 10k-stream target. This module is
the streaming replacement (``detail="windowed"`` on the engine):

- :class:`FleetAggregator` consumes one *batch* of per-lane scalars per
  chunk interval (vectorized numpy — accuracies, wire bytes, end-to-end
  delays) and folds them into exact running sums, a bounded ring of
  per-window summaries, per-SLO-tier attainment counters, and two delay
  sketches. Nothing it holds grows with streams x chunks: state is
  O(windows + tiers + sketch).
- :class:`P2Quantile` is the classic P-squared streaming quantile
  estimator (Jain & Chlamtac 1985): five markers, O(1) state, no stored
  samples.
- :class:`ReservoirSample` is a seeded uniform reservoir: while fewer
  samples than the capacity have been seen it holds *all* of them (its
  percentile is then exact — what the parity tests pin); past capacity
  it degrades gracefully to a uniform subsample.
- :class:`AggregateResult` is the frozen summary the engine returns on
  ``FleetResult.aggregate``; it JSON round-trips (:meth:`~AggregateResult.
  to_wire`) so the multi-host allgather ships windowed summaries instead
  of per-chunk lists, and :meth:`AggregateResult.merge` is the cross-host
  reduction (exact for sums/counters/attainment, approximate for the
  quantile sketches).

Accumulation-order contract: batch sums use ``np.sum`` over the active
lanes in lane order, accumulated across chunks in arrival order, all in
float64 — the parity tests reproduce exactly that order against the
per-chunk list path and require bit equality for accuracy and byte
totals.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SLOTier:
    """A service class: per-chunk end-to-end delay budget.

    ``slo_s`` is the total per-chunk delay (encode + queue + stream, the
    :class:`~repro_torch.core.pipeline.ChunkResult` ``total_delay_s``) a
    chunk must meet to count as attained. ``weight`` is the tier's share of the
    stream population when a workload generator samples classes.
    """

    name: str
    slo_s: float
    weight: float = 1.0

    def __post_init__(self):
        if self.slo_s <= 0.0:
            raise ValueError(f"tier {self.name!r} needs a positive SLO")
        if self.weight < 0.0:
            raise ValueError(f"tier {self.name!r} needs a non-negative "
                             f"weight")


#: the default three-class ladder benchmarks use (weights sum to 1)
DEFAULT_TIERS: Tuple[SLOTier, ...] = (
    SLOTier("gold", slo_s=0.25, weight=0.2),
    SLOTier("silver", slo_s=0.5, weight=0.3),
    SLOTier("bronze", slo_s=1.5, weight=0.5),
)


class P2Quantile:
    """P-squared single-quantile estimator: 5 markers, O(1) state.

    Exact while fewer than 5 observations have been seen; afterwards the
    markers track the ``q``-quantile with piecewise-parabolic height
    adjustment. Deterministic (no sampling), so tests can pin its output.
    """

    def __init__(self, q: float = 0.9):
        if not 0.0 < q < 1.0:
            raise ValueError("quantile must be in (0, 1)")
        self.q = q
        self.n = 0
        self._heights: List[float] = []
        self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
        self._want = [1.0, 1.0 + 2.0 * q, 1.0 + 4.0 * q, 3.0 + 2.0 * q, 5.0]
        self._dwant = [0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0]

    def update(self, x: float):
        x = float(x)
        self.n += 1
        if self.n <= 5:
            self._heights.append(x)
            self._heights.sort()
            return
        h, pos = self._heights, self._pos
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while x >= h[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            pos[i] += 1.0
        for i in range(5):
            self._want[i] += self._dwant[i]
        for i in (1, 2, 3):
            d = self._want[i] - pos[i]
            if (d >= 1.0 and pos[i + 1] - pos[i] > 1.0) or \
               (d <= -1.0 and pos[i - 1] - pos[i] < -1.0):
                d = 1.0 if d >= 0 else -1.0
                # piecewise-parabolic height prediction
                hp = h[i] + d / (pos[i + 1] - pos[i - 1]) * (
                    (pos[i] - pos[i - 1] + d)
                    * (h[i + 1] - h[i]) / (pos[i + 1] - pos[i])
                    + (pos[i + 1] - pos[i] - d)
                    * (h[i] - h[i - 1]) / (pos[i] - pos[i - 1]))
                if not h[i - 1] < hp < h[i + 1]:  # fall back to linear
                    j = i + (1 if d > 0 else -1)
                    hp = h[i] + d * (h[j] - h[i]) / (pos[j] - pos[i])
                h[i] = hp
                pos[i] += d

    def extend(self, xs: Sequence[float]):
        for x in np.asarray(xs, np.float64).ravel():
            self.update(x)

    @property
    def value(self) -> float:
        if self.n == 0:
            return float("nan")
        if self.n <= 5:
            return float(np.percentile(self._heights, self.q * 100.0))
        return float(self._heights[2])

    # -- wire ------------------------------------------------------------
    def state(self) -> dict:
        return {"q": self.q, "n": self.n,
                "heights": [float(x) for x in self._heights],
                "pos": [float(x) for x in self._pos],
                "want": [float(x) for x in self._want]}

    @classmethod
    def from_state(cls, st: dict) -> "P2Quantile":
        sk = cls(st["q"])
        sk.n = int(st["n"])
        sk._heights = [float(x) for x in st["heights"]]
        sk._pos = [float(x) for x in st["pos"]]
        sk._want = [float(x) for x in st["want"]]
        return sk

    @staticmethod
    def merged_value(states: Sequence[dict], q: float) -> float:
        """Approximate ``q``-quantile of the union of several sketches:
        each sketch contributes its marker heights as a tiny weighted
        empirical distribution (mass split by the marker's cumulative
        fractions, scaled by its count) and the weighted percentile is
        interpolated over the pooled points. Exact when every sketch is
        still in its exact (<=5 samples) phase."""
        pts: List[Tuple[float, float]] = []
        for st in states:
            n = st["n"]
            if n == 0:
                continue
            hs = st["heights"]
            if n <= 5:
                pts.extend((float(h), 1.0) for h in hs)
                continue
            cum = [0.0, st["q"] / 2.0, st["q"], (1.0 + st["q"]) / 2.0, 1.0]
            for i, h in enumerate(hs):
                lo = cum[i - 1] if i > 0 else cum[0]
                hi = cum[i + 1] if i < 4 else cum[4]
                pts.append((float(h), n * (hi - lo) / 2.0))
        if not pts:
            return float("nan")
        pts.sort()
        heights = np.array([p[0] for p in pts])
        weights = np.array([p[1] for p in pts])
        cumw = np.cumsum(weights) - 0.5 * weights
        target = q * float(weights.sum())
        return float(np.interp(target, cumw, heights))


class ReservoirSample:
    """Seeded uniform reservoir over a scalar stream, vectorized per
    batch. Holds every sample while ``n <= capacity`` (percentiles are
    then *exact*); past capacity each new sample replaces a uniformly
    random slot with probability ``capacity / n`` (Vitter's algorithm R,
    batched). Deterministic in its seed."""

    def __init__(self, capacity: int = 2048, seed: int = 0):
        if capacity < 1:
            raise ValueError("reservoir capacity must be positive")
        self.capacity = int(capacity)
        self.seed = int(seed)
        self._rng = np.random.RandomState(seed)
        self.n = 0
        self._buf = np.empty(0, np.float64)

    def extend(self, xs: Sequence[float]):
        xs = np.asarray(xs, np.float64).ravel()
        if xs.size == 0:
            return
        free = self.capacity - self._buf.size
        if free > 0:
            take = xs[:free]
            self._buf = np.concatenate([self._buf, take])
            self.n += take.size
            xs = xs[free:]
            if xs.size == 0:
                return
        # batched algorithm R: sample i (1-based global index n+i+1) kept
        # with prob capacity/(n+i+1), landing on a uniform slot
        idx = self.n + 1 + np.arange(xs.size, dtype=np.float64)
        keep = self._rng.rand(xs.size) < (self.capacity / idx)
        slots = self._rng.randint(0, self.capacity, size=xs.size)
        self.n += int(xs.size)
        if np.any(keep):
            # later duplicates win, matching the sequential algorithm
            self._buf[slots[keep]] = xs[keep]

    def percentile(self, p: float) -> float:
        if self._buf.size == 0:
            return float("nan")
        return float(np.percentile(self._buf, p))

    @property
    def exact(self) -> bool:
        """True while the reservoir still holds every observed sample."""
        return self.n <= self.capacity

    def state(self) -> dict:
        # the generator state rides along so a suspended/resumed
        # reservoir keeps sampling the exact sequence the uninterrupted
        # one would — without it resumption is only exact pre-overflow
        kind, keys, pos, has_g, g = self._rng.get_state()
        return {"capacity": self.capacity, "seed": self.seed,
                "n": self.n, "buf": [float(x) for x in self._buf],
                "rng": [kind, [int(k) for k in keys], int(pos),
                        int(has_g), float(g)]}

    @classmethod
    def from_state(cls, st: dict) -> "ReservoirSample":
        rs = cls(st["capacity"], st["seed"])
        rs.n = int(st["n"])
        rs._buf = np.asarray(st["buf"], np.float64)
        if "rng" in st:
            kind, keys, pos, has_g, g = st["rng"]
            rs._rng.set_state((kind, np.asarray(keys, np.uint32),
                               int(pos), int(has_g), float(g)))
        return rs

    @staticmethod
    def merged_percentile(states: Sequence[dict], p: float) -> float:
        """Percentile over pooled reservoirs. While every reservoir still
        holds all its samples the pool IS the full sample set, so this
        returns exactly ``np.percentile`` of it — the per-chunk list
        path's number, bit for bit. Past overflow it degrades to a
        weighted percentile where each reservoir's samples carry weight
        ``n / len(buf)``, so hosts with more traffic count
        proportionally."""
        states = [st for st in states if len(st["buf"])]
        if not states:
            return float("nan")
        if all(st["n"] <= len(st["buf"]) for st in states):
            pooled = np.concatenate(
                [np.asarray(st["buf"], np.float64) for st in states])
            return float(np.percentile(pooled, p))
        vals, wts = [], []
        for st in states:
            buf = np.asarray(st["buf"], np.float64)
            vals.append(buf)
            wts.append(np.full(buf.size, st["n"] / buf.size))
        v = np.concatenate(vals)
        w = np.concatenate(wts)
        order = np.argsort(v, kind="stable")
        v, w = v[order], w[order]
        cumw = np.cumsum(w) - 0.5 * w
        return float(np.interp(p / 100.0 * w.sum(), cumw, v))


@dataclasses.dataclass
class WindowStats:
    """Exact running sums for one aggregation window (a contiguous block
    of ``window`` chunk intervals)."""

    wi: int                     # window index: ci // window
    n: int = 0                  # served stream-chunks
    sum_acc: float = 0.0
    sum_bytes: float = 0.0
    sum_delay: float = 0.0
    max_delay: float = 0.0
    attained: Optional[np.ndarray] = None   # (n_tiers,) int
    total: Optional[np.ndarray] = None      # (n_tiers,) int

    def to_wire(self) -> dict:
        return {"wi": self.wi, "n": self.n, "sum_acc": self.sum_acc,
                "sum_bytes": self.sum_bytes, "sum_delay": self.sum_delay,
                "max_delay": self.max_delay,
                "attained": [int(x) for x in self.attained],
                "total": [int(x) for x in self.total]}

    @classmethod
    def from_wire(cls, d: dict) -> "WindowStats":
        return cls(wi=int(d["wi"]), n=int(d["n"]),
                   sum_acc=float(d["sum_acc"]),
                   sum_bytes=float(d["sum_bytes"]),
                   sum_delay=float(d["sum_delay"]),
                   max_delay=float(d["max_delay"]),
                   attained=np.asarray(d["attained"], np.int64),
                   total=np.asarray(d["total"], np.int64))


@dataclasses.dataclass(frozen=True)
class AggregateConfig:
    """How the engine should aggregate when ``detail="windowed"``.

    ``window`` chunk intervals per summary window; the ring keeps the
    last ``n_windows`` of them (older windows stay in the *global*
    counters — nothing is lost, only per-window resolution ages out).
    ``tier_of`` maps stream id -> tier name; unmapped streams land in the
    first tier. ``quantile`` is the headline delay quantile (p90).
    """

    window: int = 8
    n_windows: int = 64
    tiers: Tuple[SLOTier, ...] = DEFAULT_TIERS
    tier_of: Optional[Mapping[int, str]] = None
    quantile: float = 0.9
    reservoir: int = 2048
    seed: int = 0

    def build(self, tenant_of: Optional[Mapping[int, int]] = None,
              tenant_tiers: Optional[Sequence[Sequence[SLOTier]]] = None,
              ) -> "FleetAggregator":
        """Build the aggregator; a tenanted engine threads its stream ->
        tenant map and per-tenant SLO ladders through here (they are
        serving-plane wiring, not user aggregation policy, so they ride
        as build arguments rather than config fields)."""
        return FleetAggregator(window=self.window, n_windows=self.n_windows,
                               tiers=self.tiers, tier_of=self.tier_of,
                               quantile=self.quantile,
                               reservoir=self.reservoir, seed=self.seed,
                               tenant_of=tenant_of,
                               tenant_tiers=tenant_tiers)


class FleetAggregator:
    """Streaming per-window fleet accounting (see module docstring).

    :meth:`observe` takes one chunk interval's *active-lane batch* as
    numpy arrays — the vectorized host path hands it per-lane
    accuracies, wire bytes, and end-to-end delays — and updates:

    - exact global float64 running sums (accuracy, bytes, delay), the
      served-chunk count, and the max delay;
    - the ring of per-window :class:`WindowStats`;
    - per-SLO-tier (attained, total) counters via one ``np.bincount``;
    - the P-squared and reservoir delay sketches.

    State is O(windows + tiers + sketch + streams-ever-seen); the last
    term is one bool per stream id (identity, not history).
    """

    def __init__(self, window: int = 8, n_windows: int = 64,
                 tiers: Sequence[SLOTier] = DEFAULT_TIERS,
                 tier_of: Optional[Mapping[int, str]] = None,
                 quantile: float = 0.9, reservoir: int = 2048,
                 seed: int = 0,
                 tenant_of: Optional[Mapping[int, int]] = None,
                 tenant_tiers: Optional[Sequence[Sequence[SLOTier]]] = None):
        if window < 1:
            raise ValueError("window must be >= 1 chunk intervals")
        if not tiers:
            raise ValueError("at least one SLO tier is required")
        names = [t.name for t in tiers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names: {names}")
        self.window = int(window)
        self.n_windows = int(n_windows)
        self.tiers = tuple(tiers)
        self.quantile = float(quantile)
        self._tier_index = {t.name: i for i, t in enumerate(self.tiers)}
        self._slo = np.asarray([t.slo_s for t in self.tiers], np.float64)
        if tier_of:
            for sid, name in tier_of.items():
                if name not in self._tier_index:
                    raise ValueError(f"stream {sid} maps to unknown tier "
                                     f"{name!r}; tiers: {names}")
        self._tier_of = dict(tier_of or {})
        #: dense sid -> tier index cache, grown on demand (vectorized
        #: lookup per chunk instead of a per-lane dict probe)
        self._tier_arr = np.zeros(0, np.int64)
        self._served = np.zeros(0, bool)  # sid -> ever served
        self._windows: Dict[int, WindowStats] = {}
        self._cis: List[int] = []  # served chunk intervals, arrival order
        self.n = 0
        self.sum_acc = 0.0
        self.sum_bytes = 0.0
        self.sum_delay = 0.0
        self.max_delay = 0.0
        self.attained = np.zeros(len(self.tiers), np.int64)
        self.total = np.zeros(len(self.tiers), np.int64)
        self.p2 = P2Quantile(quantile)
        self.res = ReservoirSample(reservoir, seed)
        # -- per-tenant accounting (multi-tenant serving) ------------------
        # active iff the engine declared tenancy; single-tenant engines
        # skip it entirely, keeping their state and wire bit-identical to
        # the pre-tenant format
        self._tenant_of: Dict[int, int] = dict(tenant_of or {})
        self.n_tenants = 0
        if tenant_tiers is not None:
            self.n_tenants = len(tenant_tiers)
        elif self._tenant_of:
            self.n_tenants = max(self._tenant_of.values()) + 1
        if self.n_tenants:
            n_t = len(self.tiers)
            if tenant_tiers is None:
                tenant_tiers = [self.tiers] * self.n_tenants
            self.tenant_tiers = tuple(tuple(ts) for ts in tenant_tiers)
            for t, ladder in enumerate(self.tenant_tiers):
                if len(ladder) != n_t:
                    raise ValueError(
                        f"tenant {t}'s SLO ladder has {len(ladder)} tiers "
                        f"but the fleet ladder has {n_t}; per-tenant "
                        f"ladders reuse the fleet's tier classes (only "
                        f"slo_s may differ per tenant)")
            for t_idx in self._tenant_of.values():
                if not 0 <= t_idx < self.n_tenants:
                    raise ValueError(f"tenant_of maps to tenant {t_idx}; "
                                     f"only {self.n_tenants} tenants "
                                     f"declared")
            #: (T, K) per-tenant per-tier delay budget
            self._t_slo = np.asarray(
                [[tier.slo_s for tier in ladder]
                 for ladder in self.tenant_tiers], np.float64)
            self.t_n = np.zeros(self.n_tenants, np.int64)
            self.t_sum_acc = np.zeros(self.n_tenants, np.float64)
            self.t_sum_bytes = np.zeros(self.n_tenants, np.float64)
            self.t_sum_delay = np.zeros(self.n_tenants, np.float64)
            self.t_attained = np.zeros((self.n_tenants, n_t), np.int64)
            self.t_total = np.zeros((self.n_tenants, n_t), np.int64)
        else:
            self.tenant_tiers = None
        self._tenant_arr = np.zeros(0, np.int64)  # dense sid -> tenant

    # -- sid -> tier dense cache -----------------------------------------
    def _grow(self, n: int):
        old = self._tier_arr.size
        if n <= old:
            return
        arr = np.zeros(n, np.int64)
        arr[:old] = self._tier_arr
        for sid, name in self._tier_of.items():
            if old <= sid < n:
                arr[sid] = self._tier_index[name]
        self._tier_arr = arr
        served = np.zeros(n, bool)
        served[:old] = self._served
        self._served = served
        tarr = np.zeros(n, np.int64)
        tarr[:self._tenant_arr.size] = self._tenant_arr
        for sid, t_idx in self._tenant_of.items():
            if self._tenant_arr.size <= sid < n:
                tarr[sid] = t_idx
        self._tenant_arr = tarr

    def observe(self, ci: int, sids: Sequence[int],
                accs: np.ndarray, bytes_: np.ndarray,
                delays: np.ndarray):
        """Fold one chunk interval's active-lane batch in. All arrays are
        (n_active,), aligned with ``sids`` (lane order)."""
        sids = np.asarray(sids, np.int64)
        accs = np.asarray(accs, np.float64)
        bytes_ = np.asarray(bytes_, np.float64)
        delays = np.asarray(delays, np.float64)
        a = sids.size
        if not (accs.size == bytes_.size == delays.size == a):
            raise ValueError("observe needs equally sized lane batches")
        if a == 0:
            return
        if sids.size and int(sids.max()) >= self._tier_arr.size:
            self._grow(int(sids.max()) + 1)
        self._served[sids] = True
        self._cis.append(int(ci))
        # exact accumulators: np.sum over lanes, += across chunks — the
        # order the parity tests reproduce bit-for-bit
        self.n += int(a)
        self.sum_acc += float(np.sum(accs))
        self.sum_bytes += float(np.sum(bytes_))
        self.sum_delay += float(np.sum(delays))
        self.max_delay = max(self.max_delay, float(delays.max()))
        tier_idx = self._tier_arr[sids]
        n_t = len(self.tiers)
        att = np.bincount(tier_idx, weights=(delays <= self._slo[tier_idx]),
                          minlength=n_t).astype(np.int64)
        tot = np.bincount(tier_idx, minlength=n_t).astype(np.int64)
        self.attained += att
        self.total += tot
        wi = int(ci) // self.window
        w = self._windows.get(wi)
        if w is None:
            w = WindowStats(wi=wi,
                            attained=np.zeros(n_t, np.int64),
                            total=np.zeros(n_t, np.int64))
            self._windows[wi] = w
            while len(self._windows) > self.n_windows:  # age out oldest
                del self._windows[min(self._windows)]
        w.n += int(a)
        w.sum_acc += float(np.sum(accs))
        w.sum_bytes += float(np.sum(bytes_))
        w.sum_delay += float(np.sum(delays))
        w.max_delay = max(w.max_delay, float(delays.max()))
        w.attained += att
        w.total += tot
        self.p2.extend(delays)
        self.res.extend(delays)
        if self.n_tenants:
            # per-tenant fold: same vectorized bincount shape, flattened
            # over (tenant, tier) pairs; attainment is judged against the
            # *tenant's* ladder budget (_t_slo), the fleet-wide counters
            # above stay on the fleet ladder untouched
            ten_idx = self._tenant_arr[sids]
            self.t_n += np.bincount(ten_idx, minlength=self.n_tenants)
            self.t_sum_acc += np.bincount(ten_idx, weights=accs,
                                          minlength=self.n_tenants)
            self.t_sum_bytes += np.bincount(ten_idx, weights=bytes_,
                                            minlength=self.n_tenants)
            self.t_sum_delay += np.bincount(ten_idx, weights=delays,
                                            minlength=self.n_tenants)
            flat = ten_idx * n_t + tier_idx
            ok = delays <= self._t_slo[ten_idx, tier_idx]
            size = self.n_tenants * n_t
            self.t_attained += np.bincount(
                flat, weights=ok, minlength=size).astype(np.int64).reshape(
                    self.n_tenants, n_t)
            self.t_total += np.bincount(flat, minlength=size).reshape(
                self.n_tenants, n_t)

    # -- suspend/resume ---------------------------------------------------
    def export_state(self) -> dict:
        """JSON-serializable snapshot of every mutable accumulator — the
        piece of serving state a draining host checkpoints so its adopter
        resumes windowed aggregation mid-run, bit-exactly (the sketches
        carry their generator state, see ``ReservoirSample.state``)."""
        st = {
            "n": int(self.n), "sum_acc": float(self.sum_acc),
            "sum_bytes": float(self.sum_bytes),
            "sum_delay": float(self.sum_delay),
            "max_delay": float(self.max_delay),
            "attained": [int(x) for x in self.attained],
            "total": [int(x) for x in self.total],
            "windows": [self._windows[wi].to_wire()
                        for wi in sorted(self._windows)],
            "cis": [int(c) for c in self._cis],
            "served": [int(s) for s in np.flatnonzero(self._served)],
            "p2": self.p2.state(), "res": self.res.state(),
        }
        if self.n_tenants:
            st["tenants"] = {
                "t_n": [int(x) for x in self.t_n],
                "t_sum_acc": [float(x) for x in self.t_sum_acc],
                "t_sum_bytes": [float(x) for x in self.t_sum_bytes],
                "t_sum_delay": [float(x) for x in self.t_sum_delay],
                "t_attained": [[int(x) for x in row]
                               for row in self.t_attained],
                "t_total": [[int(x) for x in row] for row in self.t_total],
            }
        return st

    def import_state(self, st: dict) -> "FleetAggregator":
        """Restore :meth:`export_state` output into this (freshly built)
        aggregator; the configuration (window, tiers, quantile) comes
        from the constructor and must match the exporting side's."""
        self.n = int(st["n"])
        self.sum_acc = float(st["sum_acc"])
        self.sum_bytes = float(st["sum_bytes"])
        self.sum_delay = float(st["sum_delay"])
        self.max_delay = float(st["max_delay"])
        self.attained = np.asarray(st["attained"], np.int64)
        self.total = np.asarray(st["total"], np.int64)
        if self.attained.size != len(self.tiers):
            raise ValueError(
                f"aggregator state carries {self.attained.size} tiers "
                f"but this aggregator is configured with "
                f"{len(self.tiers)}; drain and adopt sides must share "
                f"one AggregateConfig")
        self._windows = {int(w["wi"]): WindowStats.from_wire(w)
                         for w in st["windows"]}
        self._cis = [int(c) for c in st["cis"]]
        served = [int(s) for s in st["served"]]
        if served:
            self._grow(max(served) + 1)
            self._served[np.asarray(served, np.int64)] = True
        self.p2 = P2Quantile.from_state(st["p2"])
        self.res = ReservoirSample.from_state(st["res"])
        ten = st.get("tenants")
        if ten is not None:
            if not self.n_tenants:
                raise ValueError(
                    "aggregator state carries per-tenant counters but "
                    "this aggregator was built untenanted; drain and "
                    "adopt sides must share the tenant declaration")
            if len(ten["t_n"]) != self.n_tenants:
                raise ValueError(
                    f"aggregator state carries {len(ten['t_n'])} tenants "
                    f"but this aggregator is configured with "
                    f"{self.n_tenants}")
            self.t_n = np.asarray(ten["t_n"], np.int64)
            self.t_sum_acc = np.asarray(ten["t_sum_acc"], np.float64)
            self.t_sum_bytes = np.asarray(ten["t_sum_bytes"], np.float64)
            self.t_sum_delay = np.asarray(ten["t_sum_delay"], np.float64)
            self.t_attained = np.asarray(ten["t_attained"], np.int64)
            self.t_total = np.asarray(ten["t_total"], np.int64)
        elif self.n_tenants:
            raise ValueError(
                "this aggregator was built tenanted but the state to "
                "import carries no per-tenant counters")
        return self

    def result(self) -> "AggregateResult":
        served = tuple(int(s) for s in np.flatnonzero(self._served))
        tenant_kw = {}
        if self.n_tenants:
            tenant_kw = dict(
                tenant_tiers=self.tenant_tiers,
                tenant_of={s: int(self._tenant_arr[s]) for s in served},
                t_n=self.t_n.copy(), t_sum_acc=self.t_sum_acc.copy(),
                t_sum_bytes=self.t_sum_bytes.copy(),
                t_sum_delay=self.t_sum_delay.copy(),
                t_attained=self.t_attained.copy(),
                t_total=self.t_total.copy())
        return AggregateResult(
            window=self.window, quantile=self.quantile,
            tiers=self.tiers, n=self.n, sum_acc=self.sum_acc,
            sum_bytes=self.sum_bytes, sum_delay=self.sum_delay,
            max_delay=self.max_delay,
            attained=self.attained.copy(), total=self.total.copy(),
            windows=tuple(self._windows[wi]
                          for wi in sorted(self._windows)),
            stream_ids=served,
            cis=tuple(self._cis),
            p2_state=self.p2.state(), res_state=self.res.state(),
            **tenant_kw)


@dataclasses.dataclass(frozen=True)
class AggregateResult:
    """The windowed summary a ``detail="windowed"`` run returns instead
    of per-chunk lists. Everything except the delay quantile sketches is
    exact; the sketches are exact until the reservoir overflows."""

    window: int
    quantile: float
    tiers: Tuple[SLOTier, ...]
    n: int                       # served stream-chunks
    sum_acc: float
    sum_bytes: float
    sum_delay: float
    max_delay: float
    attained: np.ndarray         # (n_tiers,)
    total: np.ndarray            # (n_tiers,)
    windows: Tuple[WindowStats, ...]
    stream_ids: Tuple[int, ...]  # every stream id that ever served
    cis: Tuple[int, ...]         # served chunk intervals, arrival order
    p2_state: dict
    res_state: dict
    # -- per-tenant plane (None on untenanted runs: the wire format and
    # merge semantics of single-tenant results are unchanged) -------------
    tenant_tiers: Optional[Tuple[Tuple[SLOTier, ...], ...]] = None
    tenant_of: Optional[Mapping[int, int]] = None  # served sid -> tenant
    t_n: Optional[np.ndarray] = None               # (T,) served chunks
    t_sum_acc: Optional[np.ndarray] = None         # (T,)
    t_sum_bytes: Optional[np.ndarray] = None       # (T,)
    t_sum_delay: Optional[np.ndarray] = None       # (T,)
    t_attained: Optional[np.ndarray] = None        # (T, K)
    t_total: Optional[np.ndarray] = None           # (T, K)

    # -- headline metrics -------------------------------------------------
    @property
    def n_streams(self) -> int:
        return len(self.stream_ids)

    @property
    def accuracy(self) -> float:
        """Mean accuracy per served stream-chunk (the pooled mean — at
        fleet scale the per-stream-then-fleet double mean and this agree
        whenever streams serve comparable chunk counts)."""
        return self.sum_acc / self.n if self.n else float("nan")

    @property
    def mean_bytes(self) -> float:
        return self.sum_bytes / self.n if self.n else float("nan")

    @property
    def mean_delay_s(self) -> float:
        return self.sum_delay / self.n if self.n else float("nan")

    def delay_percentile(self, p: float) -> float:
        """Reservoir percentile — exact while the reservoir never
        overflowed, a uniform-subsample estimate past that."""
        return ReservoirSample.merged_percentile([self.res_state], p)

    @property
    def p90_delay(self) -> float:
        return self.delay_percentile(90.0)

    @property
    def p90_delay_p2(self) -> float:
        """The P-squared estimate of the configured quantile (cross-check
        for the reservoir; O(1) state even at unbounded n)."""
        return P2Quantile.merged_value([self.p2_state], self.quantile)

    def attainment(self) -> Dict[str, float]:
        """Per-tier SLO attainment: fraction of the tier's served
        stream-chunks whose end-to-end delay met the tier budget."""
        out = {}
        for i, t in enumerate(self.tiers):
            tot = int(self.total[i])
            out[t.name] = float(self.attained[i]) / tot if tot \
                else float("nan")
        return out

    @property
    def tenanted(self) -> bool:
        return self.t_n is not None

    @property
    def n_tenants(self) -> int:
        return len(self.t_n) if self.tenanted else 0

    def accuracy_by_tenant(self) -> Tuple[float, ...]:
        """Mean accuracy per served stream-chunk, per tenant (the
        acceptance metric the 2-tenant parity test compares against
        dedicated single-tenant engines)."""
        if not self.tenanted:
            raise ValueError("untenanted aggregate has no per-tenant "
                             "accuracy")
        return tuple(
            float(self.t_sum_acc[t]) / int(self.t_n[t])
            if self.t_n[t] else float("nan")
            for t in range(self.n_tenants))

    def attainment_by_tenant(self) -> Tuple[Dict[str, float], ...]:
        """Per-tenant per-tier attainment, judged against each tenant's
        own SLO ladder."""
        if not self.tenanted:
            raise ValueError("untenanted aggregate has no per-tenant "
                             "attainment")
        out = []
        for t, ladder in enumerate(self.tenant_tiers):
            d = {}
            for i, tier in enumerate(ladder):
                tot = int(self.t_total[t, i])
                d[tier.name] = float(self.t_attained[t, i]) / tot if tot \
                    else float("nan")
            out.append(d)
        return tuple(out)

    def summary(self) -> dict:
        s = {"stream_chunks": self.n, "n_streams": self.n_streams,
             "accuracy": self.accuracy, "bytes_per_chunk": self.mean_bytes,
             "mean_delay_s": self.mean_delay_s,
             "p90_delay_s": self.p90_delay, "max_delay_s": self.max_delay}
        for name, frac in self.attainment().items():
            s[f"slo_{name}"] = frac
        if self.tenanted:
            accs = self.accuracy_by_tenant()
            atts = self.attainment_by_tenant()
            for t in range(self.n_tenants):
                s[f"tenant{t}_chunks"] = int(self.t_n[t])
                s[f"tenant{t}_accuracy"] = accs[t]
                for name, frac in atts[t].items():
                    s[f"tenant{t}_slo_{name}"] = frac
        return s

    def relabel(self, mapping: Mapping[int, int]) -> "AggregateResult":
        """Translate stream ids through ``mapping`` (host-local lane ->
        global stream id, for the cross-host wire). Only identity moves;
        every counter and sketch is id-agnostic."""
        tenant_of = self.tenant_of
        if tenant_of is not None:
            tenant_of = {int(mapping[s]): t for s, t in tenant_of.items()}
        return dataclasses.replace(
            self, stream_ids=tuple(sorted(int(mapping[s])
                                          for s in self.stream_ids)),
            tenant_of=tenant_of)

    # -- wire + cross-host merge ------------------------------------------
    def to_wire(self) -> dict:
        d = {
            "window": self.window, "quantile": self.quantile,
            "tiers": [{"name": t.name, "slo_s": t.slo_s,
                       "weight": t.weight} for t in self.tiers],
            "n": self.n, "sum_acc": self.sum_acc,
            "sum_bytes": self.sum_bytes, "sum_delay": self.sum_delay,
            "max_delay": self.max_delay,
            "attained": [int(x) for x in self.attained],
            "total": [int(x) for x in self.total],
            "windows": [w.to_wire() for w in self.windows],
            "stream_ids": [int(s) for s in self.stream_ids],
            "cis": [int(c) for c in self.cis],
            "p2": self.p2_state, "res": self.res_state,
        }
        if self.tenanted:
            # tenant ids on the wire: per-tenant ladders, the served
            # sid -> tenant map ([sid, tenant] pairs — JSON object keys
            # would stringify the sids), and the per-tenant counters.
            # Untenanted payloads omit the key entirely: old consumers
            # and old payloads both keep working
            d["tenants"] = {
                "tiers": [[{"name": t.name, "slo_s": t.slo_s,
                            "weight": t.weight} for t in ladder]
                          for ladder in self.tenant_tiers],
                "tenant_of": [[int(s), int(t)]
                              for s, t in sorted(self.tenant_of.items())],
                "t_n": [int(x) for x in self.t_n],
                "t_sum_acc": [float(x) for x in self.t_sum_acc],
                "t_sum_bytes": [float(x) for x in self.t_sum_bytes],
                "t_sum_delay": [float(x) for x in self.t_sum_delay],
                "t_attained": [[int(x) for x in row]
                               for row in self.t_attained],
                "t_total": [[int(x) for x in row] for row in self.t_total],
            }
        return d

    @classmethod
    def from_wire(cls, d: dict) -> "AggregateResult":
        tenant_kw = {}
        ten = d.get("tenants")
        if ten is not None:
            tenant_kw = dict(
                tenant_tiers=tuple(
                    tuple(SLOTier(t["name"], t["slo_s"], t["weight"])
                          for t in ladder) for ladder in ten["tiers"]),
                tenant_of={int(s): int(t) for s, t in ten["tenant_of"]},
                t_n=np.asarray(ten["t_n"], np.int64),
                t_sum_acc=np.asarray(ten["t_sum_acc"], np.float64),
                t_sum_bytes=np.asarray(ten["t_sum_bytes"], np.float64),
                t_sum_delay=np.asarray(ten["t_sum_delay"], np.float64),
                t_attained=np.asarray(ten["t_attained"], np.int64),
                t_total=np.asarray(ten["t_total"], np.int64))
        return cls(
            window=int(d["window"]), quantile=float(d["quantile"]),
            tiers=tuple(SLOTier(t["name"], t["slo_s"], t["weight"])
                        for t in d["tiers"]),
            n=int(d["n"]), sum_acc=float(d["sum_acc"]),
            sum_bytes=float(d["sum_bytes"]),
            sum_delay=float(d["sum_delay"]),
            max_delay=float(d["max_delay"]),
            attained=np.asarray(d["attained"], np.int64),
            total=np.asarray(d["total"], np.int64),
            windows=tuple(WindowStats.from_wire(w) for w in d["windows"]),
            stream_ids=tuple(int(s) for s in d["stream_ids"]),
            cis=tuple(int(c) for c in d["cis"]),
            p2_state=d["p2"], res_state=d["res"], **tenant_kw)

    @classmethod
    def merge(cls, parts: Sequence["AggregateResult"]) -> "AggregateResult":
        """Cross-host reduction. Counters, sums, attainment, and window
        stats combine exactly (hosts serve disjoint streams); the merged
        quantile comes from the pooled weighted reservoirs (exact while
        no host's reservoir overflowed). Raises on overlapping stream
        ids or mismatched tier ladders — those are topology bugs."""
        parts = list(parts)
        if not parts:
            raise ValueError("nothing to merge")
        first = parts[0]
        for p in parts[1:]:
            if p.tiers != first.tiers:
                raise ValueError(f"cannot merge aggregates with different "
                                 f"tier ladders: {p.tiers} vs {first.tiers}")
            if p.window != first.window:
                raise ValueError("cannot merge aggregates with different "
                                 "window sizes")
            if p.tenanted != first.tenanted or (
                    first.tenanted and p.tenant_tiers != first.tenant_tiers):
                raise ValueError(
                    "cannot merge aggregates with different tenant "
                    "declarations; every host of one fleet shares the "
                    "TenantSpec tuple")
        seen: Dict[int, int] = {}
        for h, p in enumerate(parts):
            for sid in p.stream_ids:
                if sid in seen:
                    raise ValueError(f"stream {sid} reported by two "
                                     f"merged aggregates (hosts {seen[sid]} "
                                     f"and {h})")
                seen[sid] = h
        windows: Dict[int, WindowStats] = {}
        n_t = len(first.tiers)
        for p in parts:
            for w in p.windows:
                m = windows.get(w.wi)
                if m is None:
                    m = WindowStats(wi=w.wi,
                                    attained=np.zeros(n_t, np.int64),
                                    total=np.zeros(n_t, np.int64))
                    windows[w.wi] = m
                m.n += w.n
                m.sum_acc += w.sum_acc
                m.sum_bytes += w.sum_bytes
                m.sum_delay += w.sum_delay
                m.max_delay = max(m.max_delay, w.max_delay)
                m.attained += w.attained
                m.total += w.total
        cis = sorted({ci for p in parts for ci in p.cis})
        merged_res = {
            "capacity": max(p.res_state["capacity"] for p in parts),
            "seed": first.res_state["seed"],
            "n": sum(p.res_state["n"] for p in parts),
            "buf": [],  # filled below via pooled weighted samples
        }
        # pool reservoir samples with per-host weights folded in by
        # repetition-free weighting: keep the raw per-host states inside
        # merged_percentile's weighting instead of materializing repeats
        pooled_vals: List[float] = []
        for p in parts:
            pooled_vals.extend(p.res_state["buf"])
        merged_res["buf"] = pooled_vals
        # the pooled buffer is only exact when every part was exact; the
        # count records the true total so .exact-style checks stay honest
        p2 = {"q": first.quantile,
              "n": sum(p.p2_state["n"] for p in parts),
              # store the merged estimate as a degenerate 1-marker state
              "heights": [P2Quantile.merged_value(
                  [p.p2_state for p in parts], first.quantile)],
              "pos": [1.0], "want": [1.0]}
        if p2["n"] == 0:
            p2["heights"] = []
        tenant_kw = {}
        if first.tenanted:
            # hosts hold disjoint sids (validated above), so the tenant
            # maps union cleanly and the counters sum exactly
            merged_of: Dict[int, int] = {}
            for p in parts:
                merged_of.update(p.tenant_of)
            tenant_kw = dict(
                tenant_tiers=first.tenant_tiers, tenant_of=merged_of,
                t_n=np.sum([p.t_n for p in parts], axis=0),
                t_sum_acc=np.sum([p.t_sum_acc for p in parts], axis=0),
                t_sum_bytes=np.sum([p.t_sum_bytes for p in parts], axis=0),
                t_sum_delay=np.sum([p.t_sum_delay for p in parts], axis=0),
                t_attained=np.sum([p.t_attained for p in parts], axis=0),
                t_total=np.sum([p.t_total for p in parts], axis=0))
        return cls(
            window=first.window, quantile=first.quantile,
            tiers=first.tiers,
            n=sum(p.n for p in parts),
            sum_acc=float(sum(p.sum_acc for p in parts)),
            sum_bytes=float(sum(p.sum_bytes for p in parts)),
            sum_delay=float(sum(p.sum_delay for p in parts)),
            max_delay=max(p.max_delay for p in parts),
            attained=np.sum([p.attained for p in parts], axis=0),
            total=np.sum([p.total for p in parts], axis=0),
            windows=tuple(windows[wi] for wi in sorted(windows)),
            stream_ids=tuple(sorted(seen)),
            cis=tuple(cis),
            p2_state=p2, res_state=merged_res, **tenant_kw)
