"""The port's serving observability (``repro_torch.obs``: span tracer,
metrics registry, drift monitor) and its hooks in the engine, speculative
decoding, prefix cache and Galaxy executor, against the reference's
``repro.obs`` and engine: the cases of ``tests/test_obs.py`` on the port,
then the same scripted calls through both registries, traced zoo serves of
reduced qwen1.5-0.5b with a tick clock injected into both tracers (the
same trace events, counters and gauges as the reference engine; time
histograms by count), the step pricer's inputs, the zero-call gate with
telemetry off, ``reset_stats`` scopes, the Galaxy executor's ring-wire
gauges against the reference's formula, a traced Galaxy serve on an
uneven plan on ``LocalRing``, and the speculative hooks.

Weights are drawn with numpy (``test_torch_prefix_cache._numpy_params``)
and carried to both packages; greedy tokens are compared exactly.
"""
import itertools

import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread, so the xdist workers beside it keep their cores
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro.core.execplan import ExecPlan as JExecPlan  # noqa: E402
from repro.obs import DriftMonitor as JDriftMonitor  # noqa: E402
from repro.obs import MetricsRegistry as JMetricsRegistry  # noqa: E402
from repro.obs import Tracer as JTracer  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.core import hmp  # noqa: E402
from repro_torch.core.execplan import ExecPlan  # noqa: E402
from repro_torch.core.ring import LocalRing  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    DriftMonitor, MetricsRegistry, RequestTracks, Tracer,
    itl_seconds, percentile, percentile_summary, ttft_percentiles,
)
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.galaxy import GalaxyHMPExecutor  # noqa: E402
from test_torch_spec import _zoo  # noqa: E402

#: time-valued histograms (latencies, measured/simulated ratios): compared
#: by count only
TIME_HISTOGRAMS = ("ttft_s", "itl_s", "sim_drift_ratio")
#: the port's own counters (``EngineStats``), absent from the reference
PORT_COUNTERS = ("prefill_oneshots", "prefill_waves")


# --- metrics registry -----------------------------------------------------------

def test_counter_scopes_and_monotonicity():
    reg = MetricsRegistry()
    c = reg.counter("decode_steps")
    c.inc()
    c.inc(4)
    assert c.value == 5 and c.lifetime == 5
    c.set_run(9)  # the stats-facade write path (read + assign)
    assert c.value == 9 and c.lifetime == 9
    with pytest.raises(ValueError, match="may not decrease"):
        c.set_run(3)
    with pytest.raises(ValueError, match="negative"):
        c.inc(-1)
    reg.reset_run()
    assert c.value == 0 and c.lifetime == 9
    c.inc(2)
    assert c.value == 2 and c.lifetime == 11


def test_gauge_and_histogram_scopes():
    reg = MetricsRegistry()
    g = reg.gauge("queue_depth")
    g.set(3)
    g.set_max(1)  # peak tracking keeps the max
    assert g.value == 3
    g.set_max(7)
    assert g.value == 7

    h = reg.histogram("ttft_s")
    for v in (1.0, 2.0, 2.0, 10.0):
        h.observe(v)
    assert h.count == 4 and h.values == (1.0, 2.0, 2.0, 10.0)
    assert h.percentile(50) == 2.0
    assert h.value_counts() == {1.0: 1, 2.0: 2, 10.0: 1}
    reg.reset_run()
    assert h.count == 0 and g.value == 0
    assert h.percentile(50, scope="lifetime") == 2.0
    s = h.summary(scope="lifetime")
    assert s["n"] == 4 and s["min"] == 1.0 and s["max"] == 10.0
    with pytest.raises(ValueError, match="unknown scope"):
        h.summary(scope="bogus")


def test_registry_collision_snapshot_prometheus():
    reg = MetricsRegistry()
    reg.counter("requests").inc(3)
    reg.gauge("kv_pool_occupancy").set(0.5)
    reg.histogram("itl_s").observe(0.25)
    with pytest.raises(ValueError, match="different kind"):
        reg.gauge("requests")
    assert "requests" in reg and "nope" not in reg
    assert reg.names() == ["requests", "kv_pool_occupancy", "itl_s"]

    snap = reg.snapshot()
    assert snap["scope"] == "run"
    assert snap["counters"]["requests"] == 3
    assert snap["gauges"]["kv_pool_occupancy"] == 0.5
    assert snap["histograms"]["itl_s"]["n"] == 1
    with pytest.raises(ValueError):
        reg.snapshot(scope="bogus")

    text = reg.to_prometheus()
    assert "# TYPE repro_requests_total counter" in text
    assert "repro_requests_total 3" in text
    assert "# TYPE repro_kv_pool_occupancy gauge" in text
    assert "# TYPE repro_itl_s summary" in text
    assert 'repro_itl_s{quantile="0.5"} 0.25' in text
    assert "repro_itl_s_count 1" in text


def test_shared_latency_helpers():
    class R:
        def __init__(self, submit, times):
            self.submit_time = submit
            self.token_times = times

    reqs = [R(0.0, [1.0, 1.5, 2.5]), R(1.0, [1.2]), R(None, []), R(0.5, [])]
    assert percentile([], 50) != percentile([], 50)  # NaN on empty
    assert percentile([3.0, 1.0, 2.0], 50) == 2.0
    assert percentile_summary([1.0, 2.0])["p50"] == 1.0  # nearest-rank
    assert itl_seconds(reqs) == [0.5, 1.0]
    out = ttft_percentiles(reqs)
    assert set(out) == {"p50", "p95", "n"} and out["n"] == 2
    assert out["p50"] == pytest.approx(0.2) and out["p95"] == 1.0


def _script(reg):
    """One scripted call sequence: every instrument kind, both scopes, a
    reset, help texts, names to sanitize, an empty histogram."""
    reg.counter("requests", "requests submitted").inc(3)
    reg.counter("decode_steps").inc()
    reg.counter("decode_steps").set_run(7)
    reg.gauge("kv_pool_occupancy", "used / usable pool pages").set(0.375)
    reg.gauge("kv_pages_peak").set_max(5)
    reg.gauge("kv_pages_peak").set_max(2)
    h = reg.histogram("ttft_s", "time to first token (s)")
    for v in (0.5, 0.125, 2.0, 0.25, 1.0):
        h.observe(v)
    reg.histogram("sim_drift_ratio/decode").observe(3.5)
    reg.histogram("9_empty")
    reg.reset_run()
    reg.counter("requests").inc(2)
    h.observe(0.75)
    reg.gauge("queue_depth").set(4)
    return reg


@pytest.mark.parametrize("scope", ["run", "lifetime"])
def test_registry_export_matches_reference(scope):
    reg, jreg = _script(MetricsRegistry()), _script(JMetricsRegistry())
    assert reg.names() == jreg.names()
    snap, jsnap = reg.snapshot(scope), jreg.snapshot(scope)
    assert repr(snap) == repr(jsnap)  # NaN summaries compare by text
    assert reg.to_prometheus(scope) == jreg.to_prometheus(scope)
    assert reg.to_prometheus(scope, prefix="x_") == jreg.to_prometheus(scope, prefix="x_")


# --- tracer -------------------------------------------------------------------------

def _fake_clock(times):
    it = iter(times)
    return lambda: next(it)


def _tick_clock():
    """A clock that advances one microsecond per read."""
    n = itertools.count()
    return lambda: next(n) * 1e-6


def test_tracer_chrome_json_wellformed():
    # clock: t0, begin a, begin b, end b, instant, end a
    tr = Tracer(clock=_fake_clock([0.0, 1e-6, 2e-6, 5e-6, 6e-6, 9e-6]))
    tr.begin("engine", "outer", step=1)
    tr.begin("engine", "inner")
    tr.end("engine")
    tr.instant("engine", "mark")
    tr.end("engine", tokens=3)

    obj = tr.to_json()
    assert set(obj) == {"traceEvents", "displayTimeUnit"}
    meta = [e for e in obj["traceEvents"] if e["ph"] == "M"]
    assert {m["name"] for m in meta} == {"process_name", "thread_name"}
    spans = [e for e in obj["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in spans] == ["outer", "inner"]  # sorted by ts
    for e in spans:
        assert {"name", "cat", "ph", "pid", "tid", "ts", "dur", "args"} <= set(e)
        assert e["dur"] >= 0
    outer, inner = spans
    assert inner["tid"] == outer["tid"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert outer["args"] == {"step": 1, "tokens": 3}
    inst = [e for e in obj["traceEvents"] if e["ph"] == "i"]
    assert len(inst) == 1 and inst[0]["name"] == "mark"


def test_tracer_open_span_export_and_stack_errors():
    tr = Tracer(clock=_fake_clock([0.0, 1e-6, 2e-6, 3e-6]))
    with pytest.raises(RuntimeError, match="no open span"):
        tr.end("engine")
    tr.begin("engine", "loop")
    assert tr.open_spans() == [(tr.tid("engine"), "loop")]
    with pytest.raises(RuntimeError, match="open spans"):
        tr.to_json()
    assert tr.to_json(allow_open=True)["traceEvents"]
    tr.end("engine")
    assert tr.open_spans() == []


def test_tracer_negative_clock_clamped_and_span_context(tmp_path):
    tr = Tracer(clock=_fake_clock([0.0, 5e-6, 3e-6, 4e-6, 6e-6]))  # goes backwards
    tr.begin("t", "s")
    tr.end("t")
    with tr.span("t", "ctx", k=1):
        pass
    spans = [e for e in tr.to_json()["traceEvents"] if e["ph"] == "X"]
    assert {e["name"]: e["dur"] for e in spans} == {"s": 0.0, "ctx": 2.0}
    tr.write(str(tmp_path / "t.json"))
    assert (tmp_path / "t.json").read_text().startswith('{"traceEvents"')


def test_tracer_matches_reference_event_for_event():
    tr, jtr = Tracer(clock=_tick_clock()), JTracer(clock=_tick_clock())
    for t in (tr, jtr):
        t.begin("engine", "a", x=1)
        t.instant("req 3", "submit")
        t.begin("engine", "b")
        t.end("engine", y=2)
        t.end("engine")
        with t.span(7, "c"):
            t.instant(7, "i", z=3)
    assert tr.to_json() == jtr.to_json()


def test_request_tracks_phase_discipline():
    tr = Tracer()
    tk = RequestTracks(tr)
    tk.submit(7)
    with pytest.raises(ValueError, match="already tracked"):
        tk.submit(7)
    tk.phase(7, "prefill", slot=0)
    with pytest.raises(ValueError, match="monotone"):
        tk.phase(7, "prefill")
    tk.event(7, "spec_rollback", rejected=2)
    tk.phase(7, "decode")
    assert tk.is_open(7) and tk.open_uids() == [7]
    tk.finish(7, tokens=4)
    assert not tk.is_open(7) and tk.open_uids() == []
    with pytest.raises(ValueError, match="not in an open phase"):
        tk.finish(7)
    names = [e["name"] for e in tr.to_json()["traceEvents"] if e["ph"] == "X"]
    assert names == ["queued", "prefill", "decode"]


def test_request_tracks_random_interleavings_property():
    """Random admit/retire/phase/spec-event interleavings over many
    requests never leave an open or out-of-order span."""
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.given(st.lists(st.tuples(st.integers(0, 7), st.integers(0, 99)), max_size=200))
    @hyp.settings(deadline=None, max_examples=50)
    def run(ops):
        tr = Tracer()
        tk = RequestTracks(tr)
        state = {}  # uid -> phase index (None = retired)
        for uid, r in ops:
            ph = state.get(uid, -1)
            if ph == -1:
                tk.submit(uid)
                state[uid] = 0
            elif ph is None:
                continue  # retired uids never come back
            elif r % 4 == 0 or ph == 2:
                tk.finish(uid, tokens=r)  # retire from any phase
                state[uid] = None
            elif r % 4 == 1:
                tk.event(uid, "spec_rollback", rejected=r)
            else:
                nxt = min(2, ph + (2 if r % 8 == 7 else 1))  # may skip
                tk.phase(uid, RequestTracks.PHASES[nxt])
                state[uid] = nxt
        for uid in list(tk.open_uids()):
            tk.finish(uid)
        assert tr.open_spans() == []
        obj = tr.to_json()  # raises on any unclosed span
        by_tid = {}
        for e in obj["traceEvents"]:
            if e["ph"] == "X":
                by_tid.setdefault(e["tid"], []).append(e)
        for evs in by_tid.values():
            evs.sort(key=lambda e: e["ts"])
            for a, b in zip(evs, evs[1:]):
                assert a["dur"] >= 0
                assert a["ts"] + a["dur"] <= b["ts"] + 1e-9

    run()


# --- drift monitor -------------------------------------------------------------------

def test_drift_monitor_ratios_and_summary_match_reference():
    def pricer(kind, rows, context):
        return 0.5 if kind != "nope" else None

    reg, jreg = MetricsRegistry(), JMetricsRegistry()
    mon, jmon = DriftMonitor(pricer, registry=reg), JDriftMonitor(pricer, registry=jreg)
    for m in (mon, jmon):
        assert m.observe("decode", 1.0, rows=1, context=8) == 2.0
        assert m.observe("prefill_chunk", 0.25, rows=4, context=8, synced=False) == 0.5
        assert m.observe("nope", 1.0) is None  # unpriceable: skipped
        assert m.observe("decode", -1.0) is None  # clock glitch: skipped
        assert m.observe("spec_verify", 0.75, rows=5, context=12) == 1.5
    assert mon.records == jmon.records and len(mon.records) == 3
    s = mon.summary()
    assert repr(s) == repr(jmon.summary())
    assert s["decode"]["n"] == 1 and s["decode"]["p50"] == 2.0
    assert s["prefill_chunk_dispatch"]["p50"] == 0.5
    assert s["all"]["n"] == 2 and s["all_dispatch"]["n"] == 1
    snap = reg.snapshot()
    assert repr(snap) == repr(jreg.snapshot())
    assert snap["histograms"]["sim_drift_ratio"]["n"] == 2
    assert snap["histograms"]["sim_drift_ratio_prefill_chunk_dispatch"]["n"] == 1
    assert DriftMonitor(pricer).observe("decode", 1.0) == 2.0  # no registry bound


# --- engine integration: reduced qwen1.5-0.5b, against the reference engine ----------

def _requests(req):
    """``tests/test_obs.py:_requests``."""
    return [req(uid=i, prompt=[1 + (i * 7 + j) % 200 for j in range(6)],
                max_new_tokens=8 if i % 2 == 0 else 3)
            for i in range(5)]


def _engines(**kw):
    """Both packages' engines over the same weights, as ``test_obs.py:_engine``
    builds them (the tracers, pricers and registries given per package)."""
    (jex, ex) = _zoo(0)
    kw.setdefault("scheduler", "continuous")
    jkw = {k: v[0] if isinstance(v, tuple) else v for k, v in kw.items()}
    pkw = {k: v[1] if isinstance(v, tuple) else v for k, v in kw.items()}
    return (JEngine(executor=jex, max_batch=2, max_len=32, page_size=8, **jkw),
            ServingEngine(ex, max_batch=2, max_len=32, page_size=8, **pkw))


def _run(engine, req, extra=()):
    for r in _requests(req) + [req(**e) for e in extra]:
        engine.submit(r)
    return engine.run()


def _span_coverage(tracer, done):
    obj = tracer.to_json()
    spans = [e for e in obj["traceEvents"] if e.get("ph") == "X"]
    names = {e["tid"]: e["args"]["name"] for e in obj["traceEvents"]
             if e.get("ph") == "M" and e["name"] == "thread_name"}
    cov = {}
    for r in done:
        tid = next(t for t, n in names.items() if n == f"req {r.uid}")
        track = [e for e in spans if e["tid"] == tid]
        lo = min(e["ts"] for e in track)
        hi = max(e["ts"] + e["dur"] for e in track)
        cov[r.uid] = sum(e["dur"] for e in track) / (hi - lo) if hi > lo else 1.0
    return obj, spans, cov


def _same_metrics(eng, jeng):
    """Counters and gauges equal; time histograms by count, the rest by
    value."""
    snap, jsnap = eng.metrics.snapshot(), jeng.metrics.snapshot()
    counters = {k: v for k, v in snap["counters"].items() if k not in PORT_COUNTERS}
    assert counters == jsnap["counters"]
    assert snap["gauges"] == jsnap["gauges"]
    assert set(snap["histograms"]) == set(jsnap["histograms"])
    for name, h in jsnap["histograms"].items():
        if name.startswith(TIME_HISTOGRAMS):
            assert snap["histograms"][name]["n"] == h["n"], name
        else:
            assert eng.metrics.histogram(name).values == \
                jeng.metrics.histogram(name).values, name
    return snap


WAVE_REJECT = (dict(uid=99, prompt=list(range(1, 33)), max_new_tokens=4),)


@pytest.mark.parametrize("mode", ["prefix_chunk", "wave"])
def test_traced_serve_matches_reference_engine(mode):
    """A traced zoo serve (tick clock in both tracers) gives the reference
    engine's trace-event list, counters and gauges; traced on the real
    clock it covers >= 95 % of each request's submit->retire span (a tick
    clock leaves a tick between phases); untraced, its tokens are the
    same."""
    kw = (dict(prefix_cache=True, prefill_chunk=4) if mode == "prefix_chunk"
          else dict(scheduler="wave"))
    extra = () if mode == "prefix_chunk" else WAVE_REJECT
    tracer, jtracer = Tracer(clock=_tick_clock()), JTracer(clock=_tick_clock())
    jeng, eng = _engines(tracer=(jtracer, tracer), record_times=True, **kw)
    jdone, done = _run(jeng, JRequest, extra), _run(eng, Request, extra)
    assert {r.uid: r.output for r in done} == {r.uid: r.output for r in jdone}

    assert tracer.open_spans() == []
    assert tracer.to_json() == jtracer.to_json()
    _, spans, _ = _span_coverage(tracer, [r for r in done if r.output])
    wall = Tracer()
    _, eng_wall = _engines(tracer=wall, record_times=True, **kw)
    wall_done = _run(eng_wall, Request, extra)
    assert wall.open_spans() == []
    _, _, cov = _span_coverage(wall, [r for r in wall_done if r.output])
    assert min(cov.values()) >= 0.95
    kinds = {e["name"] for e in spans}
    assert {"queued", "decode", "decode_step"} <= kinds
    assert ("prefill_chunk" if mode == "prefix_chunk" else "wave_prefill") in kinds

    snap = _same_metrics(eng, jeng)
    served = [r for r in done if r.output]
    assert snap["histograms"]["ttft_s"]["n"] == len(served)
    assert snap["histograms"]["itl_s"]["n"] == sum(len(r.output) - 1 for r in served)
    if mode == "prefix_chunk":
        assert snap["gauges"]["kv_pages_peak"] > 0
        assert snap["gauges"]["kv_pages_used"] == 0  # everything retired
        assert 0 <= snap["gauges"]["prefix_hit_rate"] <= 1
    else:
        rejected = [e for e in spans if e["args"].get("rejected")]
        assert len(rejected) == 1 and rejected[0]["name"] == "queued"
    assert "spec_accepted_per_round" in snap["histograms"]

    _, eng_off = _engines(**kw)
    off = _run(eng_off, Request, extra)
    assert {r.uid: r.output for r in off} == {r.uid: r.output for r in done}


def test_drift_pricer_sees_the_reference_steps():
    """A constant pricer receives the same (kind, rows, context) sequence
    from both engines, and the drift histograms land in each engine's own
    registry; tokens equal an untraced serve."""
    priced = {"j": [], "p": []}

    def pricer(side):
        def price(kind, *, rows, context):
            priced[side].append((kind, rows, context))
            return 1e-3
        return price

    jeng, eng = _engines(drift=(JDriftMonitor(pricer("j")), DriftMonitor(pricer("p"))),
                         prefill_chunk=4)
    jdone, done = _run(jeng, JRequest), _run(eng, Request)
    assert priced["p"] == priced["j"]
    assert {k for k, _, _ in priced["p"]} == {"decode", "prefill_chunk"}
    assert len(eng.drift.records) == len(priced["p"])
    assert all(rec["ratio"] > 0 and rec["synced"] for rec in eng.drift.records)
    snap = eng.metrics.snapshot()
    assert snap["histograms"]["sim_drift_ratio"]["n"] == len(priced["p"])
    assert snap["histograms"]["sim_drift_ratio_decode"]["n"] > 0
    assert eng.drift.registry is eng.metrics

    _, eng_off = _engines(prefill_chunk=4)
    assert ({r.uid: r.output for r in _run(eng_off, Request)}
            == {r.uid: r.output for r in done} == {r.uid: r.output for r in jdone})


@pytest.mark.parametrize("tracer", [None, "disabled"])
def test_disabled_telemetry_is_structurally_free(monkeypatch, tracer):
    """With no tracer (or a disabled one) and no record_times, serving the
    mix makes zero tracer calls and zero histogram observations, counted at
    the class level."""
    calls = []

    def counting(cls, name):
        orig = getattr(cls, name)

        def wrapped(self, *a, **k):
            calls.append((cls.__name__, name))
            return orig(self, *a, **k)
        monkeypatch.setattr(cls, name, wrapped)

    for m in ("begin", "end", "instant", "tid", "span"):
        counting(obs_trace.Tracer, m)
    counting(obs_metrics.Histogram, "observe")

    tr = Tracer(enabled=False) if tracer == "disabled" else None
    for kw in (dict(prefix_cache=True, prefill_chunk=4), dict(scheduler="wave")):
        _, eng = _engines(tracer=tr, **kw)
        done = _run(eng, Request)
        assert sum(len(r.output) for r in done) > 0
        assert eng._trace is None and eng._tracks is None
    assert calls == []


def test_stats_facade_and_reset_scopes():
    """``reset_stats()`` zeroes the run scope and keeps the lifetime scope;
    the facade is a mapping whose derived keys refuse assignment."""
    _, eng = _engines()
    done1 = _run(eng, Request)
    toks1 = sum(len(r.output) for r in done1)
    assert eng.stats["requests"] == 5
    # each request's first token comes from the prefill logits
    assert eng.stats["decode_tokens"] == toks1 - 5
    assert eng.stats["prefill_oneshots"] == 5

    eng.reset_stats()
    assert eng.stats["requests"] == 0 and eng.stats["decode_tokens"] == 0
    assert eng.prefix_stats is None
    assert eng.metrics.snapshot("lifetime")["counters"]["requests"] == 5

    done2 = _run(eng, Request)
    assert eng.stats["requests"] == 5  # this run only
    assert eng.stats["decode_tokens"] == sum(len(r.output) for r in done2) - 5
    assert eng.metrics.snapshot("lifetime")["counters"]["requests"] == 10

    assert set(dict(eng.stats)) == set(eng.stats.keys())
    assert eng.stats == dict(eng.stats)
    with pytest.raises(TypeError, match="derived"):
        eng.stats["spec_acceptance"] = 1.0
    with pytest.raises(TypeError, match="derived"):
        eng.stats["spec_accept_counts"] = {}
    with pytest.raises(TypeError):
        del eng.stats["requests"]
    with pytest.raises(KeyError):
        eng.stats["bogus"]
    with pytest.raises(ValueError, match="may not decrease"):
        eng.stats["requests"] = 0


def test_spec_hooks_match_reference_engine():
    """Speculative rounds on the zoo target with an unrelated draft, traced
    and priced in both packages: the same trace events (spec_round,
    draft_propose, spec_verify spans and spec_rollback events), the same
    ``spec_accepted_per_round`` histogram, the same priced steps."""
    (jt, pt), (jd, pd) = _zoo(0), _zoo(9)
    priced = {"j": [], "p": []}

    def pricer(side):
        def price(kind, *, rows, context):
            priced[side].append((kind, rows, context))
            return 1e-3
        return price

    tracer, jtracer = Tracer(clock=_tick_clock()), JTracer(clock=_tick_clock())
    kw = dict(max_batch=3, max_len=32, scheduler="continuous", page_size=4, spec_k=4,
              record_times=True)
    jeng = JEngine(executor=jt, draft_executor=jd, tracer=jtracer,
                   drift=JDriftMonitor(pricer("j")), **kw)
    eng = ServingEngine(pt, draft_executor=pd, tracer=tracer,
                        drift=DriftMonitor(pricer("p")), **kw)
    jdone, done = _run(jeng, JRequest), _run(eng, Request)
    assert {r.uid: r.output for r in done} == {r.uid: r.output for r in jdone}
    assert tracer.open_spans() == []
    assert tracer.to_json() == jtracer.to_json()
    names = {e["name"] for e in tracer.events}
    assert {"spec_round", "draft_propose", "spec_verify", "spec_rollback"} <= names
    assert priced["p"] == priced["j"]
    assert "spec_verify" in {k for k, _, _ in priced["p"]}
    hist = eng.metrics.histogram("spec_accepted_per_round")
    assert hist.values == jeng.metrics.histogram("spec_accepted_per_round").values
    assert hist.count == eng.stats["spec_steps"] > 0
    assert eng.stats["spec_accept_counts"] == jeng.stats["spec_accept_counts"]
    _same_metrics(eng, jeng)


# --- Galaxy executor: ring-wire gauges and a traced serve on LocalRing ---------------

PLAN = ExecPlan(heads=(6, 4, 4, 2), columns=(24, 16, 16, 8), head_dim=2,
                d_model=32, seq_shares=(3.0, 2.0, 2.0, 1.0))


def _galaxy(transport="padded", dtype=torch.float32):
    gen = torch.Generator().manual_seed(0)
    plan = PLAN.with_transport(transport)
    layers = hmp.init_stack_params(2, 32, 16, 64, generator=gen, dtype=dtype)
    embed = (torch.randn(300, 32, generator=gen) * 0.5).to(dtype)
    return GalaxyHMPExecutor(layers, embed, plan, LocalRing(4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("transport", ["padded", "bucketed"])
def test_wire_stats_match_reference_formula(transport, dtype):
    ex = _galaxy(transport, dtype)
    jplan = JExecPlan(PLAN.heads, PLAN.columns, PLAN.head_dim, PLAN.d_model,
                      PLAN.seq_shares, transport=transport)
    itemsize = np.dtype("float32" if dtype == torch.float32 else "float16").itemsize
    for seq in (None, 1, 7, 40, 256):
        want_seq = jplan.seq_grain if seq is None else seq
        rs = jplan.ring_schedule(want_seq)
        rows = rs.total_wire_rows()
        assert ex.wire_stats(seq) == {
            "ring_wire_seq": float(want_seq),
            "ring_wire_rows": float(rows),
            "ring_wire_rows_padded": float(rs.padded_wire_rows()),
            "ring_wire_bytes": float(rows * jplan.d_model * itemsize),
            "ring_wire_fraction": float(rs.wire_fraction()),
        }


def test_traced_galaxy_serve_on_local_ring():
    """The acceptance bar on the Galaxy executor: the uneven 3:2:2:1 plan
    on ``LocalRing(4)``, traced end to end with the prefix cache and
    chunks, >= 95 % span coverage, ring-wire gauges from the plan's
    ``RingSchedule``, tokens unchanged by telemetry."""
    ex = _galaxy()

    def requests():
        return [Request(uid=i, prompt=[1 + (i * 5 + j) % 250 for j in range(6 + i)],
                        max_new_tokens=6 if i % 2 == 0 else 3)
                for i in range(4)]

    def run(tracer, drift=None):
        eng = ServingEngine(ex, max_batch=2, max_len=40, scheduler="continuous",
                            page_size=8, tracer=tracer, drift=drift,
                            record_times=tracer is not None)
        for r in requests():
            eng.submit(r)
        return eng, eng.run()

    tracer = Tracer()
    drift = DriftMonitor(lambda kind, *, rows, context: 1e-3)
    eng, done = run(tracer, drift)
    assert tracer.open_spans() == []
    _, spans, cov = _span_coverage(tracer, done)
    assert min(cov.values()) >= 0.95
    assert {"prefill_chunk", "decode_step", "queued", "decode"} <= {e["name"] for e in spans}
    snap = eng.metrics.snapshot()
    assert snap["histograms"]["ttft_s"]["n"] == 4
    assert snap["gauges"]["kv_pages_peak"] > 0 and snap["gauges"]["kv_pages_used"] == 0
    ws = ex.wire_stats()
    assert {k: snap["gauges"][k] for k in ws} == ws
    assert ws["ring_wire_rows"] > 0 and 0 < snap["gauges"]["ring_wire_fraction"] <= 1
    assert {r["kind"] for r in drift.records} == {"decode", "prefill_chunk"}

    _, done_off = run(None)
    assert {r.uid: r.output for r in done} == {r.uid: r.output for r in done_off}


def test_serve_cli_trace_metrics_drift(tmp_path, capsys):
    """``launch.serve --trace --metrics --drift`` on the CPU (the zoo's
    small qwen): the trace file parses back with no open span, and the
    snapshot, Prometheus text and drift summary are printed."""
    import json

    from repro_torch.launch import serve

    out = tmp_path / "trace.json"
    serve.main(["--executor", "zoo", "--model", "qwen1.5-0.5b", "--reduce", "--device", "cpu",
                "--requests", "3", "--prompt-len", "20-40", "--max-new", "4",
                "--prefix-cache", "on", "--prefill-chunk", "16",
                "--trace", str(out), "--metrics", "--drift"])
    text = capsys.readouterr().out
    events = json.loads(out.read_text())["traceEvents"]
    assert f"trace: {sum(e['ph'] != 'M' for e in events)} events -> {out}" in text
    assert {"queued", "prefill", "decode", "prefill_chunk", "decode_step"} <= {
        e["name"] for e in events if e["ph"] == "X"}
    assert "metrics snapshot:" in text and "repro_ttft_s_count 3" in text
    assert "sim-vs-measured drift" in text and "  decode: n=" in text
    assert "  prefill_chunk: n=" in text
