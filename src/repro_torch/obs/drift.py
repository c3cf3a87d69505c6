"""Sim-vs-measured drift monitor: is the cost model still telling the truth?

Every executed serving step is *priced* with the simulator the planner
uses (``core/simulator.make_step_pricer`` over ``simulate_execplan``:
decode as the 1-row suffix case, prefill chunks and speculative verify
chunks as k-row suffix prefills), and the ``measured / simulated`` ratio
lands in a histogram per step kind.  A ratio of 1.0 means the cost model
prices this cluster exactly; a drifting p50 means the plan the engine runs
was solved against stale numbers.

The monitor is opt-in and engine-driven: the engine stamps
``time.perf_counter`` around each step and ends the stamp on a host sync.
Decode steps and speculative verify chunks sync when their logits are
sampled; a prefill chunk (one-shot or mid-prompt) has no such point, so
with a monitor on the engine adds one ``torch.cuda.synchronize()`` after
each chunk and records it ``synced=True`` like the others.  The
``synced=False`` path (a ``*_dispatch`` histogram of dispatch-only times)
is kept only for parity with the reference monitor's interface: neither
engine records a step that way, and nothing in this package calls it.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from repro_torch.obs.metrics import MetricsRegistry, percentile_summary

__all__ = ["DriftMonitor"]

# pricer(kind, rows=, context=) -> simulated seconds (None = unpriceable)
StepPricer = Callable[..., Optional[float]]


class DriftMonitor:
    """Record measured/simulated ratios of executed serving steps.

    pricer:   ``core/simulator.make_step_pricer(...)`` or any callable with
              the same shape — ``pricer(kind, rows=, context=)`` returning
              modeled seconds for one step (``None`` skips the observation).
    registry: the engine's :class:`MetricsRegistry`; the engine binds its
              own when the monitor is handed over unbound, so the drift
              histograms show up in ``engine.metrics.snapshot()``.
    """

    def __init__(self, pricer: StepPricer,
                 registry: Optional[MetricsRegistry] = None):
        self.pricer = pricer
        self.registry = registry
        self.records: List[Dict] = []

    def observe(self, kind: str, measured_s: float, *, rows: int = 1,
                context: int = 0, synced: bool = True) -> Optional[float]:
        """Price one executed step and record measured/simulated.

        ``synced=False`` marks steps whose measured time is host dispatch
        only (no sync point before the stamp): they are still recorded, in
        a ``*_dispatch`` histogram, because dispatch-time drift is a real
        (if weaker) signal — but the headline ``sim_drift_ratio`` histogram
        stays wall-time-only.
        """
        sim = self.pricer(kind, rows=rows, context=context)
        if sim is None or sim <= 0 or measured_s < 0:
            return None
        ratio = measured_s / sim
        self.records.append({
            "kind": kind, "rows": rows, "context": context,
            "measured_s": measured_s, "simulated_s": sim, "ratio": ratio,
            "synced": synced,
        })
        if self.registry is not None:
            suffix = "" if synced else "_dispatch"
            self.registry.histogram(
                f"sim_drift_ratio{suffix}",
                "measured / simulated step latency",
            ).observe(ratio)
            self.registry.histogram(
                f"sim_drift_ratio_{kind}{suffix}",
                f"measured / simulated {kind} latency",
            ).observe(ratio)
        return ratio

    def summary(self) -> Dict[str, Dict]:
        """Per-kind ratio percentiles over everything observed so far."""
        by_kind: Dict[str, List[float]] = {}
        for r in self.records:
            key = r["kind"] + ("" if r["synced"] else "_dispatch")
            by_kind.setdefault(key, []).append(r["ratio"])
            by_kind.setdefault("all" if r["synced"] else "all_dispatch",
                               []).append(r["ratio"])
        return {k: percentile_summary(v) for k, v in sorted(by_kind.items())}
