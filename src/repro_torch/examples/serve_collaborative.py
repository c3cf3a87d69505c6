"""Collaborative serving: batched requests through the serving engine, and
the paper's HMP layer schedules, on the port's executors.

    PYTHONPATH=src python -m repro_torch.examples.serve_collaborative \\
        [--device cpu] [--prefix-cache on|off] [--prefill-chunk N] [--trace OUT.json]

The ten demos of the reference's example, each on a reduced model:

1. ``serve_demo``: sampled serving of the zoo's ``TransformerExecutor``.
2. ``hmp_demo``: the four ``core/hmp.py`` ``SCHEDULES`` on four gloo
   ranks, one process per ring device (``ProcessRing``), against
   ``reference_layer``.
3. ``continuous_batching_demo``: continuous batching vs waves on skewed
   output lengths.
4. ``speculative_decoding_demo``: a draft proposes k = 4 tokens, one chunk
   prefill verifies them; greedy tokens equal plain decoding.
5. ``galaxy_serving_demo``: planner -> ``ExecPlan`` -> ``GalaxyHMPExecutor``
   -> continuous batching on an uneven 3:2:2:1 plan.
6. ``raggedsp_serving_demo``: bandwidth-aware uneven sequence tiles (one
   slow hop) served as a padded ragged layout.
7. ``overlap_transport_demo``: padded vs bucketed, double-buffered ring
   transport; greedy tokens equal.
8. ``padshed_backend_demo``: the eager pad-and-mask oracle vs the kernel
   backend's valid-length kernels; greedy tokens equal.
9. ``prefix_sharing_demo``: the shared-prefix KV cache and chunked prefill.
10. ``telemetry_demo``: the tracer, the metrics registry and the drift
    monitor on one traced serve.

The continuous scheduler admits a request when a decode slot is free and
the paged pool can reserve its worst-case pages, prefills it straight into
its pages, advances every live slot one token per step at its own depth,
and refills a retired slot from the queue on the same step.  The serving
demos hold the D devices of a Galaxy plan as D shards of one card
(``LocalRing``): the shard compute is real, a ring hop is a device copy.
``hmp_demo`` runs its ring as four processes (``launch/ranks.py``), as
the reference runs its schedules on four forced CPU devices; each rank
holds one device's shards and a hop crosses gloo.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.core import costmodel, hmp, planner
from repro_torch.core.execplan import ExecPlan
from repro_torch.core.planner import DeviceProfile, ModelProfile
from repro_torch.core.profiler import AnalyticProfiler
from repro_torch.core.ring import LocalRing
from repro_torch.core.simulator import make_step_pricer, simulate_execplan
from repro_torch.launch import ranks
from repro_torch.models.params import init_params
from repro_torch.obs import DriftMonitor, Tracer
from repro_torch.serving import (GalaxyHMPExecutor, Request, SamplerConfig, ServingEngine,
                                 TransformerExecutor)


def _zoo(dev: torch.device, seed: int = 0) -> TransformerExecutor:
    cfg = reduced(get_config("qwen1.5-0.5b"))
    gen = torch.Generator(device=dev).manual_seed(seed)
    return TransformerExecutor(init_params(cfg, generator=gen, device=dev), cfg)


def _galaxy(plan: ExecPlan, dev: torch.device, num_layers: int, d_ff: int,
            num_heads: int = 16) -> GalaxyHMPExecutor:
    """A 2-layer (d 128) Galaxy stack of random weights on ``plan``."""
    gen = torch.Generator(device=dev).manual_seed(0)
    layers = hmp.init_stack_params(num_layers, 128, num_heads, d_ff, generator=gen, device=dev)
    embed = torch.randn(500, 128, generator=gen, device=dev) * 0.5
    return GalaxyHMPExecutor(layers, embed, plan, LocalRing(plan.num_devices))


def _demo_plan(backend: str = "eager") -> ExecPlan:
    caps = [3.0, 2.0, 2.0, 1.0]
    model = ModelProfile("demo", 2, 16, 256, 1e6, 2e6)
    devs = [DeviceProfile(f"d{i}", c, 1e12) for i, c in enumerate(caps)]
    return ExecPlan.from_plan(planner.plan(model, devs), head_dim=8, d_model=128,
                              compute_backend=backend)


def _serve(executor, requests: List[Request], **kw):
    """(engine, finished requests) of one run of ``requests``."""
    eng = ServingEngine(executor, **kw)
    for r in requests:
        eng.submit(r)
    return eng, eng.run()


def serve_demo(dev):
    executor = _zoo(dev)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, 500, 16).tolist(), max_new_tokens=12)
            for i in range(10)]
    eng, done = _serve(executor, reqs, max_batch=4, max_len=64,
                       sampler=SamplerConfig(temperature=0.8, top_k=20))
    print(f"served {len(done)} requests; stats={dict(eng.stats)}")
    print(f"sample output: {done[0].output}")
    return len(done)


def hmp_rank(args) -> None:
    """One rank of ``hmp_demo``: the four schedules over the process ring;
    prints this rank's errors as a JSON line."""
    ring, dev = ranks.init(args.rank, 4, args.init_method, device=args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = hmp.init_layer_params(128, 8, 512, generator=gen, device=dev)
    x = torch.randn(1, 64, 128, generator=gen, device=dev)
    plan = ExecPlan.even(4, num_heads=8, d_ff=512, head_dim=16, d_model=128)
    ref = hmp.reference_layer(p, x)
    with torch.no_grad():
        errs = {name: float((fn(p, x, ring, plan=plan) - ref).abs().max())
                for name, fn in hmp.SCHEDULES.items()}
    ranks.finish()
    print(json.dumps(errs), flush=True)


def hmp_demo(dev):
    """The paper's four schedules on a 4-device ring (Figs. 5-7), one
    process per device: each rank's output (gathered over the ring)
    against ``reference_layer``; the largest error over the ranks."""
    argv = ["--demos", "hmp", "--device", dev.type]
    outs = ranks.launch(ranks.python_module("repro_torch.examples.serve_collaborative",
                                            argv), 4, timeout=120, capture=True)
    per_rank = [json.loads(out.strip().splitlines()[-1]) for _, out, _ in outs]
    print("HMP schedules on a 4-device ring of 4 gloo ranks (paper Fig. 5-7):")
    errs = {}
    for name in hmp.SCHEDULES:
        errs[name] = max(e[name] for e in per_rank)
        print(f"  {name:10s} matches reference: max_err={errs[name]:.2e} (4 ranks)")
    return errs


def continuous_batching_demo(dev):
    """Continuous batching vs waves on a skewed request mix."""
    executor = _zoo(dev)
    print("Continuous batching vs waves (skewed output lengths):")
    out = {}
    for scheduler in ("wave", "continuous"):
        for _ in range(2):  # the first pass warms up
            reqs = [Request(uid=i, prompt=[1 + i] * 8, max_new_tokens=24 if i % 4 == 0 else 4)
                    for i in range(12)]
            t0 = time.perf_counter()
            eng, done = _serve(executor, reqs, max_batch=4, max_len=48, scheduler=scheduler,
                               page_size=8)
            wall = time.perf_counter() - t0
        toks = sum(len(r.output) for r in done)
        out[scheduler] = {r.uid: tuple(r.output) for r in done}
        print(f"  {scheduler:10s} {toks} tokens in {wall * 1e3:6.1f}ms "
              f"({toks / wall:6.1f} tok/s, {eng.stats['decode_steps']} steps)")
    return out


def speculative_decoding_demo(dev):
    """The draft here has the target's weights (acceptance near 100 %); a
    deployment drafts with a much smaller model (``launch/serve.py
    --draft-model``)."""
    target, draft = _zoo(dev), _zoo(dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 400, 12).tolist() for _ in range(4)]
    print("Speculative decoding (draft k=4, verify in one chunk prefill):")
    outs = {}
    for spec_k in (None, 4):
        reqs = [Request(uid=i, prompt=prompts[i], max_new_tokens=16) for i in range(4)]
        t0 = time.perf_counter()
        eng, done = _serve(target, reqs, max_batch=1, max_len=48, scheduler="continuous",
                           page_size=8, draft_executor=draft if spec_k else None, spec_k=spec_k)
        wall = time.perf_counter() - t0
        outs[spec_k] = {r.uid: tuple(r.output) for r in done}
        toks = sum(len(r.output) for r in done)
        if spec_k is None:
            print(f"  plain decode  {toks} tokens in {wall * 1e3:6.1f}ms "
                  f"({eng.stats['decode_steps']} mesh steps)")
        else:
            s = eng.stats
            print(f"  speculative   {toks} tokens in {wall * 1e3:6.1f}ms "
                  f"({s['spec_steps']} rounds, acceptance {s['spec_acceptance']:.0%}, "
                  f"accept_counts={dict(sorted(s['spec_accept_counts'].items()))})")
    if outs[None] != outs[4]:
        raise AssertionError("speculation changed greedy tokens")
    print("  greedy tokens identical spec on/off")
    return outs


def galaxy_serving_demo(dev):
    """planner -> ExecPlan -> GalaxyHMPExecutor -> continuous batching."""
    plan = _demo_plan()
    print("Galaxy serving on an uneven 3:2:2:1 plan (planner -> ExecPlan -> engine):")
    print("  plan:", plan.describe())
    reqs = [Request(uid=i, prompt=list(range(1 + i, 15 + i)),
                    max_new_tokens=12 if i % 3 == 0 else 4) for i in range(6)]
    eng, done = _serve(_galaxy(plan, dev, 2, 256), reqs, max_batch=4, max_len=48,
                       scheduler="continuous", page_size=8)
    print(f"  served {len(done)} requests through the uneven plan; "
          f"stats={dict(eng.stats)}")
    return len(done)


def raggedsp_serving_demo(dev):
    """The planner solves uneven sequence tiles from capacity and per-link
    bandwidth (one slow hop); the executor runs them as a padded ragged
    layout: any prompt length, no divisibility."""
    cfg = dataclasses.replace(get_config("distilbert"), num_layers=1)
    caps = [3.0, 2.0, 2.0, 1.0]
    devs = [costmodel.DeviceSpec(f"edge{i}", flops=c * 7.1e9, mem_bw=4e9, memory_budget=1.5e9)
            for i, c in enumerate(caps)]
    links = [costmodel.mbps(1000), costmodel.mbps(1000), costmodel.mbps(100),
             costmodel.mbps(1000)]  # one slow hop
    prof = AnalyticProfiler(cfg, 128)
    pl = prof.plan(devs, links=links)
    eq = simulate_execplan(ExecPlan.from_plan(prof.plan(devs), head_dim=cfg.head_dim,
                                              d_model=cfg.d_model), cfg, devs, links, 128)
    bw = simulate_execplan(ExecPlan.from_plan(pl, head_dim=cfg.head_dim,
                                              d_model=cfg.d_model), cfg, devs, links, 128)
    # the tiny demo model takes the real sequence split
    plan = ExecPlan(heads=(6, 4, 4, 2), columns=(18, 12, 12, 6), head_dim=8, d_model=128,
                    seq_shares=tuple(pl.seq))
    print("Ragged SP on a bandwidth-heterogeneous cluster (one 100 Mbps hop):")
    print("  plan:", plan.describe())
    print(f"  simulated/layer: equal {eq.latency * 1e3:.1f}ms vs bandwidth-aware "
          f"{bw.latency * 1e3:.1f}ms ({eq.latency / bw.latency:.2f}x)")
    reqs = [Request(uid=i, prompt=list(range(1 + i, 14 + 2 * i)),
                    max_new_tokens=10 if i % 3 == 0 else 4) for i in range(6)]
    eng, done = _serve(_galaxy(plan, dev, 2, 48), reqs, max_batch=4, max_len=48,
                       scheduler="continuous", page_size=8)
    print(f"  served {len(done)} requests over ragged sequence tiles; "
          f"stats={dict(eng.stats)}")
    return len(done)


def overlap_transport_demo(dev):
    """"padded" ships the straggler's whole tile on every hop, "bucketed"
    each tile's bucket-rounded valid rows, and ``double_buffer`` issues
    the next hop before the GEMM that hides it."""
    base = ExecPlan(heads=(6, 4, 4, 2), columns=(24, 16, 16, 8), head_dim=8, d_model=128,
                    seq_shares=(3.0, 2.0, 2.0, 1.0))
    print("Overlap ring transport (padded vs bucketed + double-buffered):")
    outs = {}
    for label, plan in [("padded", base),
                        ("bucketed+db", base.with_transport("bucketed", double_buffer=True))]:
        print("  plan:", plan.describe())
        reqs = [Request(uid=i, prompt=list(range(1 + i, 12 + i)),
                        max_new_tokens=8 if i % 3 == 0 else 4) for i in range(6)]
        eng, done = _serve(_galaxy(plan, dev, 2, 64), reqs, max_batch=4, max_len=40,
                           scheduler="continuous", page_size=8)
        outs[label] = {r.uid: tuple(r.output) for r in done}
    if outs["padded"] != outs["bucketed+db"]:
        raise AssertionError("transports diverged")
    sched = plan.ring_schedule(128)
    print(f"  greedy tokens identical across transports; one rotation ships "
          f"{sched.total_wire_rows()} rows vs {sched.padded_wire_rows()} padded "
          f"({sched.wire_fraction():.0%} of the padded wire)")
    return outs


def padshed_backend_demo(dev):
    """"eager" runs the padded dense oracle (every device executes
    max(units) work, zeros included); "kernel" routes every shard GEMM,
    the prefill attention and the connectives through the valid-length
    kernels, which skip pad blocks (their plain versions on the CPU)."""
    print("Pad-shedding compute backend (eager oracle vs kernel valid-length):")
    outs = {}
    for backend in ("eager", "kernel"):
        plan = _demo_plan(backend)
        if backend == "eager":
            print("  plan:", plan.describe())
        reqs = [Request(uid=i, prompt=list(range(1 + i, 11 + i)), max_new_tokens=6)
                for i in range(4)]
        eng, done = _serve(_galaxy(plan, dev, 2, 256), reqs, max_batch=4, max_len=32,
                           scheduler="continuous", page_size=8)
        outs[backend] = {r.uid: tuple(r.output) for r in done}
    if outs["eager"] != outs["kernel"]:
        raise AssertionError("backends diverged")
    print(f"  greedy tokens identical across eager/kernel backends; kernel sheds "
          f"{plan.padding_waste():.0%} pad units")
    return outs


def prefix_sharing_demo(dev, prefix_cache: str = "on", prefill_chunk: Optional[int] = 16):
    """Radix-tree lookup -> shared-page refcount bump -> suffix-only
    chunked prefill -> insert the new full pages for later requests."""
    executor = _zoo(dev)
    rng = np.random.default_rng(0)
    system_prompt = rng.integers(1, 400, 48).tolist()
    print(f"Shared-prefix KV cache (--prefix-cache {prefix_cache}, "
          f"--prefill-chunk {prefill_chunk}):")
    out = {}
    for on in ([False, True] if prefix_cache == "on" else [False]):
        for _ in range(2):  # the first pass warms up
            reqs = [Request(uid=i, prompt=system_prompt + rng.integers(1, 400, 8).tolist(),
                            max_new_tokens=8) for i in range(10)]
            t0 = time.perf_counter()
            eng, done = _serve(executor, reqs, max_batch=4, max_len=96, scheduler="continuous",
                               page_size=8, prefix_cache=on, prefill_chunk=prefill_chunk)
            wall = time.perf_counter() - t0
        toks = sum(len(r.output) for r in done)
        label = "prefix cache on " if on else "prefix cache off"
        print(f"  {label} {toks} tokens in {wall * 1e3:6.1f}ms ({toks / wall:6.1f} tok/s, "
              f"prefilled {eng.stats['prefill_tokens']} prompt tokens, "
              f"{eng.stats['peak_shared_pages']} pages shared)")
        if on:
            print(f"  PrefixCache.stats(): {eng.prefix_stats}")
        out[on] = eng.stats["prefill_tokens"]
    return out


def telemetry_demo(dev, trace_path: Optional[str] = None):
    """One traced serve: a span track per request (queued -> prefill ->
    decode) and an engine track, exported as Chrome trace-event JSON; the
    metrics registry behind ``engine.stats``; a drift monitor pricing each
    step with the planner's simulator (nominal Jetson Nano-L specs)."""
    executor = _zoo(dev)
    cfg = executor.cfg
    rng = np.random.default_rng(0)
    system_prompt = rng.integers(1, 400, 16).tolist()
    tracer = Tracer()
    eplan = ExecPlan.even(1, num_heads=cfg.num_heads, d_ff=cfg.d_ff, head_dim=cfg.head_dim,
                          d_model=cfg.d_model)
    drift = DriftMonitor(make_step_pricer(eplan, cfg, [costmodel.jetson_nano("nano-l", 4.0)],
                                          costmodel.mbps(1000)))
    reqs = [Request(uid=i, prompt=system_prompt + rng.integers(1, 400, 6).tolist(),
                    max_new_tokens=10 if i % 3 == 0 else 4) for i in range(8)]
    eng, done = _serve(executor, reqs, max_batch=4, max_len=64, scheduler="continuous", page_size=8,
                       prefix_cache=True, prefill_chunk=8, record_times=True, tracer=tracer,
                       drift=drift)
    print("Serving telemetry (tracer + metrics registry + drift monitor):")
    snap = eng.metrics.snapshot()
    ttft, itl = snap["histograms"]["ttft_s"], snap["histograms"]["itl_s"]
    print(f"  served {len(done)} requests; ttft p50={ttft['p50'] * 1e3:.1f}ms "
          f"itl p50={itl['p50'] * 1e3:.1f}ms "
          f"prefix_hit_rate={snap['gauges']['prefix_hit_rate']:.0%} "
          f"kv_pages_peak={snap['gauges']['kv_pages_peak']:.0f}")
    spans = [e for e in tracer.to_json()["traceEvents"] if e["ph"] == "X"]
    print(f"  trace: {len(tracer.events)} events, {len(spans)} spans, "
          f"0 left open (open_spans={tracer.open_spans()})")
    if trace_path:
        tracer.write(trace_path)
        print(f"  wrote {trace_path}: open in ui.perfetto.dev")
    d = drift.summary()["all"]
    print(f"  drift (measured/simulated, nominal nano-l specs): "
          f"n={d['n']} p50={d['p50']:.2f} p95={d['p95']:.2f}")
    eng.reset_stats()
    print(f"  after reset_stats(): run requests={eng.stats['requests']}, lifetime="
          f"{eng.metrics.snapshot('lifetime')['counters']['requests']}")
    return {"spans": len(spans), "drift_n": d["n"]}


DEMOS = ("serve", "hmp", "continuous_batching", "speculative_decoding", "galaxy_serving",
         "raggedsp_serving", "overlap_transport", "padshed_backend", "prefix_sharing",
         "telemetry")


def main(argv=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    ap.add_argument("--prefix-cache", choices=("on", "off"), default="on",
                    help="shared-prefix KV cache in prefix_sharing_demo "
                         "(off runs the baseline only)")
    ap.add_argument("--prefill-chunk", type=int, default=16, metavar="N",
                    help="prefill chunk size (tokens) for prefix_sharing_demo")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write telemetry_demo's Chrome trace-event JSON here")
    ap.add_argument("--demos", default=",".join(DEMOS), help=f"comma-separated, of {DEMOS}")
    ranks.add_rank_args(ap)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return hmp_rank(args)
    dev = resolve_device(args.device)
    fns = {
        "serve": lambda: serve_demo(dev),
        "hmp": lambda: hmp_demo(dev),
        "continuous_batching": lambda: continuous_batching_demo(dev),
        "speculative_decoding": lambda: speculative_decoding_demo(dev),
        "galaxy_serving": lambda: galaxy_serving_demo(dev),
        "raggedsp_serving": lambda: raggedsp_serving_demo(dev),
        "overlap_transport": lambda: overlap_transport_demo(dev),
        "padshed_backend": lambda: padshed_backend_demo(dev),
        "prefix_sharing": lambda: prefix_sharing_demo(dev, args.prefix_cache,
                                                      args.prefill_chunk),
        "telemetry": lambda: telemetry_demo(dev, args.trace),
    }
    out = {}
    for name in args.demos.split(","):
        if name not in fns:
            raise SystemExit(f"unknown demo {name!r}; one of {DEMOS}")
        out[name] = fns[name]()
        print()
    return out


if __name__ == "__main__":
    main()
