"""Seeded, genre-based time-varying bandwidth traces (the port's own copy
of ``repro.control.traces``, which is pure numpy: the same seed gives
bitwise the same trace).

The paper's delay accounting assumes a constant uplink
(``core.pipeline.stream_delay``: ``bytes*8/bandwidth + RTT/2``). Deployed
cameras see bandwidth that varies on the seconds timescale: LTE shadowing
and handover fades, WiFi contention bursts, drone distance and fading
envelopes. A :class:`NetworkTrace` is a piecewise-constant bandwidth
signal sampled every ``dt_s`` seconds (wrapping periodically past its
end), and :meth:`NetworkTrace.transmit_time` is the exact solver that
integrates rate over the trace to answer "how long does this chunk take
to upload, starting at time t": the trace-aware replacement for
``stream_delay`` on the serving path (threaded through
``core.pipeline.UplinkClock`` by ``StreamingEngine(trace=...)``).

Generators are deterministic in their seed (numpy ``RandomState``), so a
(genre, seed) pair names a reproducible network scenario.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

import numpy as np

# Generators never emit a bandwidth below this fraction of the trace mean,
# so transmit times stay finite on every scene (a true outage would make
# the transmit-time integral diverge).
MIN_BW_FRACTION = 0.05


@dataclasses.dataclass(frozen=True, eq=False)
class NetworkTrace:
    """Piecewise-constant uplink bandwidth, wrapping periodically.

    ``bw_bps[k]`` holds on ``[k*dt_s, (k+1)*dt_s)``; past the last sample
    the trace wraps (cameras outlive any finite capture). ``rtt_s`` rides
    along so a trace fully specifies the network the way
    ``NetworkConfig`` does on the constant path.
    """

    bw_bps: np.ndarray
    dt_s: float
    rtt_s: float = 0.1
    genre: str = "custom"
    seed: int = 0

    def __post_init__(self):
        bw = np.asarray(self.bw_bps, np.float64)
        if bw.ndim != 1 or bw.size == 0:
            raise ValueError("bw_bps must be a non-empty 1-D array")
        if not np.all(bw > 0):
            raise ValueError("bandwidth samples must be positive")
        object.__setattr__(self, "bw_bps", bw)

    # -- basic signal access -------------------------------------------------
    @property
    def duration_s(self) -> float:
        return self.bw_bps.size * self.dt_s

    @property
    def mean_bps(self) -> float:
        return float(self.bw_bps.mean())

    @property
    def min_bps(self) -> float:
        return float(self.bw_bps.min())

    def bandwidth_at(self, t_s: float) -> float:
        """Instantaneous bandwidth at absolute time ``t_s`` (wraps)."""
        k = int(math.floor(t_s / self.dt_s)) % self.bw_bps.size
        return float(self.bw_bps[k])

    def scaled_to_mean(self, mean_bps: float) -> "NetworkTrace":
        """Same shape, rescaled so the time-average equals ``mean_bps`` —
        how benchmarks calibrate a genre against a measured workload."""
        return dataclasses.replace(
            self, bw_bps=self.bw_bps * (mean_bps / self.mean_bps))

    # -- transmit-time solvers ----------------------------------------------
    def transmit_time(self, n_bytes: float, start_s: float = 0.0) -> float:
        """Upload duration for ``n_bytes`` starting at ``start_s``:
        the smallest ``d`` with ``∫_{start}^{start+d} bw(t) dt = 8*bytes``.
        Walks the piecewise-constant segments exactly (no discretization
        beyond the trace's own)."""
        bits = float(n_bytes) * 8.0
        if bits <= 0.0:
            return 0.0
        K, dt = self.bw_bps.size, self.dt_s
        t = float(start_s)
        # walk segments by integer index — re-deriving k from floor(t/dt)
        # after t = seg_end can re-yield the same segment under float
        # rounding (e.g. dt = 0.1) and stall the walk forever
        k = int(math.floor(t / dt))
        while True:
            rate = float(self.bw_bps[k % K])
            seg_end = (k + 1) * dt
            cap = max(rate * (seg_end - t), 0.0)
            if cap >= bits:
                return t + bits / rate - start_s
            bits -= cap
            t = seg_end
            k += 1

    def shared_transmit_times(self, stream_bytes: Sequence[float],
                              start_s: float = 0.0) -> List[float]:
        """Processor-sharing over the time-varying uplink: N uploads start
        together at ``start_s``, every active stream gets ``bw(t)/n_active``,
        and a finisher's share is redistributed. Returns each stream's
        upload *duration* in input order (the trace analogue of
        ``core.pipeline.shared_stream_delays``, without the RTT term)."""
        n = len(stream_bytes)
        remaining = np.asarray(stream_bytes, np.float64) * 8.0
        done = np.zeros(n, np.float64)
        active = remaining > 0.0
        n_active = int(active.sum())
        K, dt = self.bw_bps.size, self.dt_s
        t = float(start_s)
        # integer segment walk, same float-rounding guard as transmit_time;
        # the per-event bookkeeping is vectorized over lanes (masked numpy
        # ops) — the old per-lane Python inner loop made each event O(N)
        # interpreter work, O(N^2) per chunk at fleet scale
        k = int(math.floor(t / dt))
        while n_active:
            rate = float(self.bw_bps[k % K])
            seg_end = (k + 1) * dt
            share = rate / n_active  # per-stream service rate
            min_rem = float(remaining[active].min())
            if min_rem / share <= seg_end - t:
                # at least one stream drains inside this segment
                t += min_rem / share
                served = min_rem
            else:
                served = max(share * (seg_end - t), 0.0)
                t = seg_end
                k += 1
            remaining[active] -= served
            finished = active & (remaining <= 1e-9)
            done[finished] = t - start_s
            active &= ~finished
            n_active = int(active.sum())
        return done.tolist()


def _ar1(rng: np.random.RandomState, n: int, rho: float,
         sigma: float) -> np.ndarray:
    """Stationary AR(1) log-domain shadowing process."""
    x = np.empty(n)
    x[0] = rng.randn() * sigma
    innov = rng.randn(n) * sigma * math.sqrt(max(1.0 - rho * rho, 1e-9))
    for i in range(1, n):
        x[i] = rho * x[i - 1] + innov[i]
    return x


def _finish(bw: np.ndarray, mean_bps: float, dt_s: float, rtt_s: float,
            genre: str, seed: int) -> NetworkTrace:
    bw = bw * (mean_bps / bw.mean())
    bw = np.maximum(bw, MIN_BW_FRACTION * mean_bps)
    return NetworkTrace(bw, dt_s, rtt_s=rtt_s, genre=genre, seed=seed)


def lte_trace(seed: int = 0, duration_s: float = 60.0, dt_s: float = 0.5,
              mean_bps: float = 4e6, rtt_s: float = 0.07) -> NetworkTrace:
    """Cellular uplink: slow log-normal shadowing plus a few deep handover
    fades (sustained dips to 15–35% of the mean for 2–6 s)."""
    rng = np.random.RandomState(seed)
    n = max(int(round(duration_s / dt_s)), 4)
    bw = np.exp(_ar1(rng, n, rho=0.92, sigma=0.35))
    for _ in range(max(1, int(duration_s / 20.0))):
        start = rng.randint(0, n)
        width = rng.randint(int(2.0 / dt_s), int(6.0 / dt_s) + 1)
        depth = rng.uniform(0.15, 0.35)
        bw[start : start + width] *= depth
    return _finish(bw, mean_bps, dt_s, rtt_s, "lte", seed)


def wifi_trace(seed: int = 0, duration_s: float = 60.0, dt_s: float = 0.5,
               mean_bps: float = 10e6, rtt_s: float = 0.02) -> NetworkTrace:
    """WLAN uplink: weakly correlated fast variation with bursty contention
    periods (airtime halves or worse while a neighbor transmits)."""
    rng = np.random.RandomState(seed)
    n = max(int(round(duration_s / dt_s)), 4)
    bw = np.exp(_ar1(rng, n, rho=0.55, sigma=0.25))
    contended = np.zeros(n, bool)
    i = 0
    while i < n:  # alternating clear/contended dwell periods
        dwell = rng.randint(int(1.0 / dt_s), int(8.0 / dt_s) + 1)
        if rng.rand() < 0.35:
            contended[i : i + dwell] = True
        i += dwell
    bw[contended] *= rng.uniform(0.25, 0.5)
    return _finish(bw, mean_bps, dt_s, rtt_s, "wifi", seed)


def drone_trace(seed: int = 0, duration_s: float = 60.0, dt_s: float = 0.5,
                mean_bps: float = 3e6, rtt_s: float = 0.04) -> NetworkTrace:
    """Aerial link: slow sinusoidal distance envelope (fly-out/fly-back)
    multiplied by fast small-scale fading."""
    rng = np.random.RandomState(seed)
    n = max(int(round(duration_s / dt_s)), 4)
    t = np.arange(n) * dt_s
    period = duration_s / rng.uniform(1.5, 2.5)
    phase = rng.uniform(0.0, 2 * math.pi)
    envelope = 1.0 - 0.55 * (0.5 + 0.5 * np.sin(2 * math.pi * t / period
                                                + phase))
    fading = np.exp(_ar1(rng, n, rho=0.3, sigma=0.3))
    return _finish(envelope * fading, mean_bps, dt_s, rtt_s, "drone", seed)


TRACE_GENRES = {
    "lte": lte_trace,
    "wifi": wifi_trace,
    "drone": drone_trace,
}


def make_trace(genre: str, seed: int = 0, **kwargs) -> NetworkTrace:
    """Build a named-genre trace (``TRACE_GENRES``), seeded."""
    try:
        gen = TRACE_GENRES[genre]
    except KeyError:
        raise KeyError(f"unknown trace genre {genre!r}; available: "
                       f"{sorted(TRACE_GENRES)}") from None
    return gen(seed=seed, **kwargs)


def constant_trace(bw_bps: float, rtt_s: float = 0.1,
                   dt_s: float = 1.0) -> NetworkTrace:
    """Degenerate single-segment trace — the constant-bandwidth model as a
    trace, for equivalence tests against ``stream_delay``."""
    return NetworkTrace(np.asarray([float(bw_bps)]), dt_s, rtt_s=rtt_s,
                        genre="constant")
