"""Span tracing: where did this request's milliseconds go?

A :class:`Tracer` records structured spans for every serving lifecycle
event and exports them as Chrome trace-event JSON (the ``traceEvents``
array format), so a serve run opens in ``chrome://tracing`` or
https://ui.perfetto.dev.

Model
-----
* One *process* (``pid``) per tracer; one *thread track* (``tid``) per
  label: the engine uses the ``"engine"`` track for its loop steps
  (prefix_lookup / prefill_chunk / decode_step / spec_round) and one
  ``"req <uid>"`` track per request for its lifecycle phases (queued →
  prefill → decode), which tile the request's submit→retire wall time.
* Spans follow stack discipline per track: :meth:`Tracer.begin` pushes,
  :meth:`Tracer.end` pops and emits one *complete* event (``ph="X"`` with
  ``ts``/``dur`` in microseconds); durations are clamped at >= 0.
* :meth:`Tracer.instant` marks zero-duration events (submit, rollback).

The tracer never synchronizes the device: CUDA runs asynchronously, and a
``torch.cuda.synchronize()`` here would change what the serve measures.
Span boundaries land on host-side points the engine already passes
through, and the engine only calls the tracer when one was passed and is
enabled, so a run without one executes no tracing call.  An engine-track
span that ends before the next sync point measures dispatch, not device
time; the request-phase spans end on real sync points (a sampled token,
a retirement).  The clock is injectable (``clock=``), so a test can drive
two tracers tick for tick.

:class:`RequestTracks` is the per-request phase bookkeeper the engine
drives: phases are strictly sequential per request, every transition
closes the previous phase, and ``finish`` closes whatever is open, so a
run ends with zero open spans.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple, Union

__all__ = ["Tracer", "RequestTracks"]


class Tracer:
    """Structured span recorder with Chrome trace-event export."""

    def __init__(self, *, enabled: bool = True, pid: int = 1,
                 process_name: str = "repro-serving", clock=None):
        self.enabled = enabled
        self.pid = pid
        self._clock = clock or time.perf_counter
        self._t0 = self._clock()
        self._events: List[dict] = []
        self._tids: Dict[str, int] = {}
        # per-tid stack of open spans: (name, cat, ts_us, args)
        self._open: Dict[int, List[Tuple[str, str, float, dict]]] = {}
        self._meta: List[dict] = [{
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": process_name},
        }]

    # --- clock / tracks -----------------------------------------------------
    def _now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def tid(self, track: Union[str, int]) -> int:
        """Stable integer track id for a label (creates the track and its
        ``thread_name`` metadata on first use)."""
        if isinstance(track, int):
            return track
        t = self._tids.get(track)
        if t is None:
            t = self._tids[track] = len(self._tids) + 1
            self._meta.append({
                "ph": "M", "name": "thread_name", "pid": self.pid, "tid": t,
                "args": {"name": track},
            })
        return t

    # --- spans --------------------------------------------------------------
    def begin(self, track: Union[str, int], name: str, cat: str = "serve",
              **args) -> None:
        tid = self.tid(track)
        self._open.setdefault(tid, []).append(
            (name, cat, self._now_us(), dict(args)))

    def end(self, track: Union[str, int], **extra_args) -> None:
        tid = self.tid(track)
        stack = self._open.get(tid)
        if not stack:
            raise RuntimeError(f"end() on track {track!r} with no open span")
        name, cat, ts, args = stack.pop()
        if extra_args:
            args.update(extra_args)
        self._events.append({
            "name": name, "cat": cat, "ph": "X", "pid": self.pid, "tid": tid,
            "ts": ts, "dur": max(0.0, self._now_us() - ts), "args": args,
        })

    @contextmanager
    def span(self, track: Union[str, int], name: str, cat: str = "serve",
             **args):
        self.begin(track, name, cat, **args)
        try:
            yield self
        finally:
            self.end(track)

    def instant(self, track: Union[str, int], name: str, cat: str = "serve",
                **args) -> None:
        self._events.append({
            "name": name, "cat": cat, "ph": "i", "s": "t", "pid": self.pid,
            "tid": self.tid(track), "ts": self._now_us(), "args": dict(args),
        })

    # --- export -------------------------------------------------------------
    def open_spans(self) -> List[Tuple[int, str]]:
        """(tid, name) of every span begun but not yet ended."""
        return [(tid, frame[0])
                for tid, stack in self._open.items() for frame in stack]

    @property
    def events(self) -> List[dict]:
        return list(self._events)

    def to_json(self, *, allow_open: bool = False) -> dict:
        """The ``chrome://tracing`` / Perfetto JSON object.

        Raises if spans are still open (an engine bug — every lifecycle
        path must close its spans) unless ``allow_open=True``.
        """
        if not allow_open and self.open_spans():
            raise RuntimeError(
                f"trace export with open spans: {self.open_spans()}"
            )
        return {
            "traceEvents": self._meta + sorted(
                self._events, key=lambda e: e["ts"]),
            "displayTimeUnit": "ms",
        }

    def write(self, path: str, *, allow_open: bool = False) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(allow_open=allow_open), f)


class RequestTracks:
    """Per-request lifecycle phases over a :class:`Tracer`.

    Drives one track per request uid through the strictly sequential phase
    chain ``queued -> prefill -> decode -> (closed)``; every transition
    closes the previous phase at the same timestamp it opens the next, so
    the phases tile submit→retire wall time with no gaps (the >=95 %
    span-coverage acceptance gate) and no request ever retires with an
    open span.
    """

    PHASES = ("queued", "prefill", "decode")

    def __init__(self, tracer: Tracer):
        self.tracer = tracer
        self._phase: Dict[int, Optional[str]] = {}

    def _track(self, uid: int) -> str:
        return f"req {uid}"

    def submit(self, uid: int) -> None:
        if uid in self._phase:
            raise ValueError(f"request {uid} already tracked")
        self.tracer.instant(self._track(uid), "submit")
        self.tracer.begin(self._track(uid), "queued", uid=uid)
        self._phase[uid] = "queued"

    def phase(self, uid: int, name: str, **args) -> None:
        """Advance to ``name``, closing the currently open phase.  Phases
        may be skipped but never revisited (monotone along ``PHASES``)."""
        cur = self._phase.get(uid)
        if cur is None:
            raise ValueError(f"request {uid} is not in an open phase")
        if self.PHASES.index(name) <= self.PHASES.index(cur):
            raise ValueError(
                f"request {uid}: phase {name!r} after {cur!r} is not monotone"
            )
        self.tracer.end(self._track(uid))
        self.tracer.begin(self._track(uid), name, uid=uid, **args)
        self._phase[uid] = name

    def event(self, uid: int, name: str, **args) -> None:
        """Zero-duration marker on the request's track (rollback, eviction)."""
        if self._phase.get(uid) is None:
            raise ValueError(f"request {uid} is not in an open phase")
        self.tracer.instant(self._track(uid), name, **args)

    def finish(self, uid: int, **args) -> None:
        """Close the open phase (retirement — from any phase)."""
        if self._phase.get(uid) is None:
            raise ValueError(f"request {uid} is not in an open phase")
        self.tracer.end(self._track(uid), **args)
        self._phase[uid] = None

    def is_open(self, uid: int) -> bool:
        return self._phase.get(uid) is not None

    def open_uids(self) -> List[int]:
        return [uid for uid, ph in self._phase.items() if ph is not None]
