"""Build accounting per padded fleet shape — the port's counterpart of
the reference's jit-compile accounting (``repro.obs.compile``).

The control plane's guarantee is that serving builds nothing new once a
fleet shape has been admitted: knob changes ride as device tensors and
admission re-pads churned fleets onto shapes already served. In the
reference a new shape costs an XLA compile, so its ``CompileCounter``
watches the jit caches of the hot programs. The port runs eagerly and
compiles no program per shape, so a jit-cache count would measure
nothing. What the fleet engine does build is counted instead:

- ``steps``: entries of ``MultiStreamEngine._steps``, the camera and
  server steps built per (controller, masked) arity;
- ``warm``: entries of ``MultiStreamEngine._warm``, one per padded fleet
  shape (and mode) the engine has warmed up. A warm-up runs both steps
  once outside the timed loop; on the card that first call at a shape
  also pays cuDNN's algorithm search, the eager counterpart of a
  compile.

Each tracked cache is anything with ``len()`` (the engine's dicts).
Metric names are the reference's (``jit_cache_size`` gauges,
``jit_recompiles`` counters and ``recompile`` instants on the warm-up
lane), so dashboards read both.
"""
from __future__ import annotations

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace


class CompileCounter:
    """Tracks the sizes of named build caches.

    >>> counter = CompileCounter.for_engine(engine)
    >>> ...  # serve a schedule that must build nothing new
    >>> counter.assert_no_recompiles()

    ``snapshot()`` re-baselines (e.g. after an expected warm-up pass);
    ``growth()`` reports per-cache deltas for assertion messages;
    ``publish()`` exports sizes/growth to the ambient metrics registry.
    """

    def __init__(self, **caches):
        for name, cache in caches.items():
            if not hasattr(cache, "__len__"):
                raise TypeError(f"{name} is not a sized cache: {cache!r}")
        self.caches = dict(caches)
        self.baseline = self.sizes()

    @classmethod
    def for_engine(cls, engine) -> "CompileCounter":
        """The fleet engine's step and warm-up caches."""
        return cls(steps=engine._steps, warm=engine._warm)

    def sizes(self) -> dict:
        return {name: len(cache) for name, cache in self.caches.items()}

    def snapshot(self) -> dict:
        """Re-baseline at the current cache sizes and return them."""
        self.baseline = self.sizes()
        return dict(self.baseline)

    def growth(self) -> dict:
        """Caches that grew (or shrank) since the baseline."""
        return {name: size - self.baseline[name]
                for name, size in self.sizes().items()
                if size != self.baseline[name]}

    def assert_no_recompiles(self, context: str = ""):
        grown = self.growth()
        assert not grown, (
            f"unexpected new builds{' (' + context + ')' if context else ''}: "
            + ", ".join(f"{name}: {self.baseline[name]}->"
                        f"{self.baseline[name] + delta}"
                        for name, delta in sorted(grown.items())))

    def assert_total(self, **expected: int):
        """Pin absolute cache sizes (e.g. one warm-up per padded shape)."""
        actual = {name: len(self.caches[name]) for name in expected}
        assert actual == expected, f"{actual} != {expected}"

    def publish(self, context: str = "") -> dict:
        """Export current cache sizes (gauges) and growth since baseline
        (counter + trace instants) to the ambient telemetry plane, then
        re-baseline. No-op (beyond the growth computation) when both the
        registry and the tracer are disabled. Returns the growth dict so
        callers can also log/assert on it."""
        grown = self.growth()
        reg = _metrics.get_metrics()
        if reg is not None:
            for name, size in self.sizes().items():
                reg.gauge("jit_cache_size", program=name).set(size)
            for name, delta in grown.items():
                if delta > 0:
                    reg.counter("jit_recompiles", program=name).inc(delta)
        tracer = _trace.get_tracer()
        if tracer is not None:
            for name, delta in sorted(grown.items()):
                if delta > 0:
                    tracer.instant("recompile", stage="warmup",
                                   program=name, new_programs=delta,
                                   context=context or None)
        self.baseline = self.sizes()
        return grown
