"""Open-loop internet-scale workload generation for fleet serving.

A copy of ``repro.control.workload`` (numpy only, the same seeded random
stream) over the port's own autoscaler and aggregate.

The churn schedules driving ``MultiStreamEngine.serve_loop`` were
hand-written: a handful of streams, a few scripted joins/leaves. This
module generates *traffic* instead — the load shape a public
video-analytics endpoint actually sees — and compiles it down to the exact
vocabulary the serving loop already consumes (an initial active set plus
per-chunk :class:`~repro_torch.control.autoscaler.ChurnEvent`s), so no
engine code changes to serve it:

- **Poisson arrivals** with an optional **diurnal** sinusoid modulating
  the arrival rate over the schedule (day/night load swing);
- **heavy-tailed (Pareto) session lengths** — most cameras connect for a
  chunk or two, a few stay for the whole run, exactly the elephant/mice
  mix that defeats mean-based provisioning;
- **per-SLO-tier stream classes**
  (:class:`~repro_torch.core.aggregate.SLOTier`, sampled by tier
  weight): each stream carries a delay budget, and windowed aggregation
  scores per-tier attainment against it.

Everything is deterministic in ``seed`` (one ``numpy.RandomState``), so a
(seed, rate, tiers) triple names a reproducible load scenario benchmarks
and tests can share, the way trace genres name network scenarios.

``max_streams`` bounds the *identity* space: the fleet's frame array is
indexed by stream id, so 10k concurrent streams do not need 100k frame
rows — once the id budget is exhausted, arrivals recycle ids of streams
that departed on an earlier chunk (a recycled camera keeps its original
SLO tier, keeping ``tier_of`` a function). Arrivals that find neither
headroom (``max_concurrent``) nor a free id are *blocked* and counted,
never silently dropped.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.control.autoscaler import ChurnEvent, apply_churn
from repro_torch.core.aggregate import (AggregateConfig, DEFAULT_TIERS,
                                       SLOTier)


@dataclasses.dataclass(frozen=True)
class Workload:
    """A compiled load scenario: the serving loop's inputs plus the
    metadata windowed aggregation needs to score it.

    ``initial`` and ``events`` feed ``serve_loop``
    verbatim; ``n_streams`` is the size of the stream-id space (the
    fleet frame array's leading dimension); ``tier_of`` maps every id to
    its SLO tier name."""

    initial: Tuple[int, ...]
    events: Tuple[ChurnEvent, ...]
    tiers: Tuple[SLOTier, ...]
    tier_of: Mapping[int, str]
    n_chunks: int
    n_streams: int
    n_blocked: int = 0   # arrivals refused for want of headroom or ids
    seed: int = 0

    def concurrency(self) -> List[int]:
        """Active-stream count per chunk interval (replays the schedule
        through the same ``apply_churn`` the serving loop uses)."""
        active = list(self.initial)
        counts = []
        for ci in range(self.n_chunks):
            active = apply_churn(active, self.events, ci)
            counts.append(len(active))
        return counts

    @property
    def peak_concurrency(self) -> int:
        return max(self.concurrency(), default=0)

    @property
    def stream_chunks(self) -> int:
        """Total stream-chunks the schedule serves (the denominator of
        per-(stream·chunk) cost metrics)."""
        return int(sum(self.concurrency()))

    def tier_fractions(self) -> Dict[str, float]:
        """Fraction of the id space per tier (sanity vs tier weights)."""
        counts = {t.name: 0 for t in self.tiers}
        for sid in range(self.n_streams):
            counts[self.tier_of[sid]] += 1
        n = max(self.n_streams, 1)
        return {k: v / n for k, v in counts.items()}

    def aggregate_config(self, window: int = 8, n_windows: int = 64,
                         quantile: float = 0.9, reservoir: int = 2048,
                         agg_seed: int = 0) -> AggregateConfig:
        """The matching ``detail="windowed"`` engine config: same tier
        ladder, same stream->tier mapping."""
        return AggregateConfig(window=window, n_windows=n_windows,
                               tiers=self.tiers, tier_of=dict(self.tier_of),
                               quantile=quantile, reservoir=reservoir,
                               seed=agg_seed)


def make_workload(n_chunks: int,
                  rate_per_chunk: float = 1.0,
                  seed: int = 0,
                  tiers: Sequence[SLOTier] = DEFAULT_TIERS,
                  mean_session_chunks: float = 4.0,
                  pareto_alpha: float = 1.6,
                  diurnal_amplitude: float = 0.0,
                  diurnal_period: Optional[float] = None,
                  initial_streams: Optional[int] = None,
                  max_concurrent: Optional[int] = None,
                  max_streams: Optional[int] = None) -> Workload:
    """Generate an open-loop arrival schedule.

    ``rate_per_chunk`` is the mean Poisson arrival rate per chunk
    interval; ``diurnal_amplitude`` in [0, 1) modulates it sinusoidally
    with period ``diurnal_period`` intervals (default: one full cycle
    over the schedule). Session lengths are Pareto(``pareto_alpha``)
    scaled so their mean is ``mean_session_chunks`` (alpha <= 1 has no
    finite mean and is rejected), with a 1-chunk floor.

    ``initial_streams`` (default: the steady-state estimate
    ``rate * mean_session``, at least 1) are already connected at chunk
    0. ``max_concurrent`` caps the active set — arrivals beyond it are
    blocked and counted, the open-loop analogue of admission refusing a
    join. ``max_streams`` caps the id space (see module docstring).
    """
    if n_chunks < 1:
        raise ValueError("schedule needs at least one chunk interval")
    if pareto_alpha <= 1.0:
        raise ValueError("pareto_alpha must exceed 1 (finite mean "
                         "session length)")
    if not 0.0 <= diurnal_amplitude < 1.0:
        raise ValueError("diurnal_amplitude must lie in [0, 1)")
    tiers = tuple(tiers)
    weights = np.asarray([t.weight for t in tiers], np.float64)
    if weights.sum() <= 0:
        raise ValueError("tier weights must sum to a positive value")
    weights = weights / weights.sum()
    rng = np.random.RandomState(seed)
    period = diurnal_period or float(n_chunks)
    # Pareto(alpha) via (rng.pareto + 1) * m has mean m * alpha/(alpha-1);
    # pick m so the session mean lands on mean_session_chunks
    m = mean_session_chunks * (pareto_alpha - 1.0) / pareto_alpha

    def session_len() -> int:
        return max(1, int(math.ceil((rng.pareto(pareto_alpha) + 1.0) * m)))

    def rate_at(ci: int) -> float:
        if diurnal_amplitude == 0.0:
            return rate_per_chunk
        return rate_per_chunk * max(
            0.0, 1.0 + diurnal_amplitude
            * math.sin(2.0 * math.pi * ci / period))

    tier_of: Dict[int, str] = {}
    depart: Dict[int, List[int]] = {}
    available: List[int] = []      # recycled ids free since an earlier chunk
    just_released: List[int] = []  # freed this chunk; reusable next chunk
    next_sid = 0
    n_blocked = 0
    n_active = 0

    def alloc() -> Optional[int]:
        nonlocal next_sid
        if max_streams is None or next_sid < max_streams:
            sid = next_sid
            next_sid += 1
            return sid
        return available.pop(0) if available else None

    def admit(ci: int, joins: List[int]) -> None:
        nonlocal n_active, n_blocked
        sid = alloc()
        if sid is None:
            n_blocked += 1
            return
        if sid not in tier_of:  # recycled ids keep their original tier
            tier_of[sid] = tiers[rng.choice(len(tiers), p=weights)].name
        joins.append(sid)
        n_active += 1
        end = ci + session_len()
        if end < n_chunks:
            depart.setdefault(end, []).append(sid)

    if initial_streams is None:
        initial_streams = max(1, int(round(rate_per_chunk
                                           * mean_session_chunks)))
    if max_concurrent is not None and initial_streams > max_concurrent:
        # the t=0 analogue of the mid-run headroom check: every initial
        # stream beyond the cap is a blocked arrival, counted exactly as
        # a mid-run join refused for want of headroom would be
        n_blocked += initial_streams - max_concurrent
        initial_streams = max_concurrent
    initial: List[int] = []
    for _ in range(initial_streams):
        admit(0, initial)

    events: List[ChurnEvent] = []
    for ci in range(1, n_chunks):
        available.extend(just_released)
        just_released = []
        leaves = depart.pop(ci, [])
        n_active -= len(leaves)
        just_released.extend(leaves)
        n_arrivals = int(rng.poisson(rate_at(ci)))
        joins: List[int] = []
        for _ in range(n_arrivals):
            if max_concurrent is not None and \
                    n_active + 1 > max_concurrent:
                n_blocked += 1
                continue
            admit(ci, joins)
        if leaves or joins:
            events.append(ChurnEvent(ci, join=tuple(joins),
                                     leave=tuple(leaves)))
    return Workload(initial=tuple(initial), events=tuple(events),
                    tiers=tiers, tier_of=tier_of, n_chunks=n_chunks,
                    n_streams=next_sid, n_blocked=n_blocked, seed=seed)
