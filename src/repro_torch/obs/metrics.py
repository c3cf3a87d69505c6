"""Metrics registry: counters, gauges and histograms for the serving stack.

One registry per :class:`~repro_torch.serving.engine.ServingEngine` is
the source of truth for the engine's stats; ``engine.stats`` is a
read/write *facade* over it, so ``engine.stats["decode_steps"]`` reads
the counter.  Three instrument kinds:

* :class:`Counter`: monotone within a scope (``prefill_tokens``,
  ``decode_steps``, ``spec_proposed``, ...).
* :class:`Gauge`: last-set value (``queue_depth``, ``kv_pool_occupancy``,
  ``prefix_hit_rate``), with :meth:`Gauge.set_max` for peak tracking.
* :class:`Histogram`: full-sample histogram with nearest-rank percentiles
  (``ttft_s``, ``itl_s``, ``spec_accepted_per_round``,
  ``sim_drift_ratio/*``).  Samples are kept (serving runs observe
  thousands, not billions), so any percentile is exact.

Every instrument carries **two scopes**: the *run* scope, zeroed by
:meth:`MetricsRegistry.reset_run` (``ServingEngine.reset_stats``), and the
*lifetime* scope, which survives resets, so a reused engine reports "this
run" and "since construction" separately.

Export: :meth:`MetricsRegistry.snapshot` returns a plain nested dict
(counters / gauges / histogram summaries) and
:meth:`MetricsRegistry.to_prometheus` renders the Prometheus text
exposition format (counters as ``_total``, histograms as summaries with
``quantile`` labels).

The module also holds the shared latency-percentile helpers:
:func:`percentile`, :func:`percentile_summary`, :func:`ttft_seconds`,
:func:`itl_seconds` and :func:`ttft_percentiles`, read from the
``Request.token_times`` stamps.

Pure Python (no torch, no numpy): the host-side bookkeeping stays
allocation-free when telemetry is off.
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, List, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "percentile", "percentile_summary",
    "ttft_seconds", "itl_seconds", "ttft_percentiles",
]


# --- shared percentile helpers ------------------------------------------------

def percentile(values: Sequence[float], p: float) -> float:
    """Nearest-rank percentile on an (unsorted) sample; nan when empty.
    The one percentile definition the histograms and the TTFT/ITL helpers
    share."""
    if not values:
        return float("nan")
    xs = sorted(values)
    k = min(len(xs) - 1, max(0, int(round(p / 100 * (len(xs) - 1)))))
    return xs[k]


def percentile_summary(values: Sequence[float],
                       ps: Iterable[float] = (50, 95, 99)) -> Dict[str, float]:
    """``{"p50": ..., "p95": ..., ...}`` plus count/sum/min/max."""
    out: Dict[str, float] = {"n": len(values)}
    xs = sorted(values)
    for p in ps:
        key = f"p{p:g}"
        if not xs:
            out[key] = float("nan")
        else:
            k = min(len(xs) - 1, max(0, int(round(p / 100 * (len(xs) - 1)))))
            out[key] = xs[k]
    out["sum"] = float(sum(xs)) if xs else 0.0
    out["min"] = xs[0] if xs else float("nan")
    out["max"] = xs[-1] if xs else float("nan")
    return out


def ttft_seconds(requests) -> List[float]:
    """Per-request time-to-first-token samples from the engine's
    ``record_times`` stamps (``token_times[0] - submit_time``).  Requests
    that emitted nothing (or ran without stamps) are skipped."""
    return [
        r.token_times[0] - r.submit_time
        for r in requests
        if r.token_times and r.submit_time is not None
    ]


def itl_seconds(requests) -> List[float]:
    """Inter-token latency samples: consecutive ``token_times`` gaps across
    all requests (a request with one token contributes none)."""
    out: List[float] = []
    for r in requests:
        ts = r.token_times
        out.extend(b - a for a, b in zip(ts, ts[1:]))
    return out


def ttft_percentiles(requests) -> Dict[str, float]:
    """TTFT p50/p95 summary: ``{"p50": s, "p95": s, "n": count}``
    (seconds)."""
    ttfts = ttft_seconds(requests)
    return {"p50": percentile(ttfts, 50), "p95": percentile(ttfts, 95),
            "n": len(ttfts)}


# --- instruments --------------------------------------------------------------

class Counter:
    """Monotone counter with run + lifetime scopes."""

    __slots__ = ("name", "help", "_run", "_life")

    def __init__(self, name: str, help: str = ""):  # noqa: A002 - prom idiom
        self.name = name
        self.help = help
        self._run = 0
        self._life = 0

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        self._run += n
        self._life += n

    @property
    def value(self):
        return self._run

    @property
    def lifetime(self):
        return self._life

    def set_run(self, value) -> None:
        """Set the run-scope value directly (the stats-facade write path:
        ``stats[k] += n`` reads then assigns).  The lifetime scope absorbs
        the delta, staying monotone across resets."""
        delta = value - self._run
        if delta < 0:
            raise ValueError(
                f"counter {self.name}: run value may not decrease "
                f"({self._run} -> {value}); use reset_run() to zero it"
            )
        self._run = value
        self._life += delta

    def reset_run(self) -> None:
        self._run = 0


class Gauge:
    """Last-set value.  Run scope only (a gauge has no meaningful sum);
    ``reset_run`` returns it to 0."""

    __slots__ = ("name", "help", "_value")

    def __init__(self, name: str, help: str = ""):  # noqa: A002
        self.name = name
        self.help = help
        self._value = 0.0

    def set(self, value) -> None:
        self._value = value

    def set_max(self, value) -> None:
        """Peak tracking: keep the maximum of all sets since the last reset."""
        if value > self._value:
            self._value = value

    @property
    def value(self):
        return self._value

    def reset_run(self) -> None:
        self._value = 0.0


class Histogram:
    """Full-sample histogram; percentiles are exact (nearest-rank).

    Run samples are zeroed by ``reset_run``; the lifetime sample list keeps
    accumulating (bounded by tokens served per engine — fine at serving
    scale, and it keeps lifetime percentiles exact too).
    """

    __slots__ = ("name", "help", "_run", "_life")

    def __init__(self, name: str, help: str = ""):  # noqa: A002
        self.name = name
        self.help = help
        self._run: List[float] = []
        self._life: List[float] = []

    def observe(self, value: float) -> None:
        self._run.append(value)
        self._life.append(value)

    @property
    def count(self) -> int:
        return len(self._run)

    @property
    def values(self) -> Tuple[float, ...]:
        return tuple(self._run)

    def percentile(self, p: float, scope: str = "run") -> float:
        return percentile(self._samples(scope), p)

    def value_counts(self, scope: str = "run") -> Dict[float, int]:
        """``{observed value: occurrences}`` — the discrete view backing
        ``stats["spec_accept_counts"]``."""
        out: Dict[float, int] = {}
        for v in self._samples(scope):
            out[v] = out.get(v, 0) + 1
        return out

    def summary(self, scope: str = "run",
                ps: Iterable[float] = (50, 95, 99)) -> Dict[str, float]:
        return percentile_summary(self._samples(scope), ps)

    def _samples(self, scope: str) -> List[float]:
        if scope == "run":
            return self._run
        if scope == "lifetime":
            return self._life
        raise ValueError(f"unknown scope {scope!r}")

    def reset_run(self) -> None:
        self._run = []


# --- registry -----------------------------------------------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    """Sanitize to the Prometheus metric-name charset."""
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


class MetricsRegistry:
    """Get-or-create instrument registry with snapshot/Prometheus export."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    # --- get-or-create ------------------------------------------------------
    def _get(self, table: Dict, cls, name: str, help: str):  # noqa: A002
        inst = table.get(name)
        if inst is None:
            for other in (self._counters, self._gauges, self._histograms):
                if other is not table and name in other:
                    raise ValueError(
                        f"metric {name!r} already registered as a different kind"
                    )
            inst = table[name] = cls(name, help)
        return inst

    def counter(self, name: str, help: str = "") -> Counter:  # noqa: A002
        return self._get(self._counters, Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:  # noqa: A002
        return self._get(self._gauges, Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:  # noqa: A002
        return self._get(self._histograms, Histogram, name, help)

    def __contains__(self, name: str) -> bool:
        return (name in self._counters or name in self._gauges
                or name in self._histograms)

    def names(self) -> List[str]:
        return (sorted(self._counters) + sorted(self._gauges)
                + sorted(self._histograms))

    # --- scopes -------------------------------------------------------------
    def reset_run(self) -> None:
        """Zero the run scope of every instrument; lifetime scopes survive."""
        for table in (self._counters, self._gauges, self._histograms):
            for inst in table.values():
                inst.reset_run()

    # --- export -------------------------------------------------------------
    def snapshot(self, scope: str = "run") -> Dict[str, Dict]:
        """Plain nested dict of every instrument's current state.

        ``scope="run"`` is the window since the last ``reset_run``;
        ``scope="lifetime"`` is since registry construction.  Gauges carry
        no lifetime scope and always report their current value.
        """
        if scope not in ("run", "lifetime"):
            raise ValueError(f"unknown scope {scope!r}")
        counters = {
            n: (c.value if scope == "run" else c.lifetime)
            for n, c in sorted(self._counters.items())
        }
        gauges = {n: g.value for n, g in sorted(self._gauges.items())}
        hists = {n: h.summary(scope) for n, h in sorted(self._histograms.items())}
        return {"scope": scope, "counters": counters, "gauges": gauges,
                "histograms": hists}

    def to_prometheus(self, scope: str = "run",
                      prefix: str = "repro_") -> str:
        """Prometheus text exposition: counters as ``<name>_total``, gauges
        bare, histograms as summaries (``quantile`` labels + _sum/_count)."""
        lines: List[str] = []
        for n, c in sorted(self._counters.items()):
            pn = _prom_name(prefix + n)
            if c.help:
                lines.append(f"# HELP {pn}_total {c.help}")
            lines.append(f"# TYPE {pn}_total counter")
            v = c.value if scope == "run" else c.lifetime
            lines.append(f"{pn}_total {v}")
        for n, g in sorted(self._gauges.items()):
            pn = _prom_name(prefix + n)
            if g.help:
                lines.append(f"# HELP {pn} {g.help}")
            lines.append(f"# TYPE {pn} gauge")
            lines.append(f"{pn} {g.value}")
        for n, h in sorted(self._histograms.items()):
            pn = _prom_name(prefix + n)
            if h.help:
                lines.append(f"# HELP {pn} {h.help}")
            lines.append(f"# TYPE {pn} summary")
            s = h.summary(scope)
            for q in (0.5, 0.95, 0.99):
                v = s[f"p{q * 100:g}"]
                if v == v:  # skip NaN quantiles of empty histograms
                    lines.append(f'{pn}{{quantile="{q}"}} {v}')
            lines.append(f"{pn}_sum {s['sum']}")
            lines.append(f"{pn}_count {s['n']}")
        return "\n".join(lines) + "\n"
