"""Serving observability: span tracing, a metrics registry, and the
sim-vs-measured drift monitor.

* ``obs.trace``: :class:`Tracer` records structured spans for every
  request lifecycle event and engine loop step, exported as Chrome
  trace-event JSON (open a serve run in ``chrome://tracing`` or
  https://ui.perfetto.dev).
* ``obs.metrics``: :class:`MetricsRegistry` of counters / gauges /
  histograms with run-vs-lifetime scopes, ``snapshot()`` and Prometheus
  text export; also the shared percentile/TTFT/ITL helpers.
* ``obs.drift``: :class:`DriftMonitor` prices each executed serving step
  with the planner's own simulator and histograms the measured/simulated
  ratio: a live cost-model drift signal.

Tracing, drift and ``record_times`` are opt-in on the serving hot path: an
engine with all three off makes no tracer call and observes no histogram
(a speculative round still observes ``spec_accepted_per_round``, the
storage of ``stats["spec_accept_counts"]``).
"""
from repro_torch.obs.drift import DriftMonitor
from repro_torch.obs.metrics import (
    Counter, Gauge, Histogram, MetricsRegistry,
    itl_seconds, percentile, percentile_summary,
    ttft_percentiles, ttft_seconds,
)
from repro_torch.obs.trace import RequestTracks, Tracer

__all__ = [
    "Tracer", "RequestTracks",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "percentile", "percentile_summary",
    "ttft_seconds", "itl_seconds", "ttft_percentiles",
    "DriftMonitor",
]
