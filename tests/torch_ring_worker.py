"""One rank of ``tests/test_torch_process_ring.py``: runs every case of the
Galaxy program on a ``ProcessRing`` (and, on rank 0, the same cases on a
``LocalRing`` in this process, under the same thread count) and saves the
results for the test process to compare.  The speculative cases hold the
draft on the rank of device ``DRAFT_DEVICE`` only, and the telemetry case
gives rank 0 alone a tracer and a drift monitor, as ``launch.serve
--ranks`` does.

    python tests/torch_ring_worker.py INPUTS.npz OUT_DIR --rank R --init-method URL

Imports the port only (the test process made the inputs with the
reference and compares against it).
"""
import argparse
import itertools
import sys
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)

from repro_torch.core import hmp  # noqa: E402
from repro_torch.core.execplan import ExecPlan  # noqa: E402
from repro_torch.core.ring import LocalRing, RingSchedule  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import ranks  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.obs import DriftMonitor, Tracer  # noqa: E402
from repro_torch.serving import engine as eng_mod  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine, TransformerExecutor  # noqa: E402
from repro_torch.serving.galaxy import GalaxyHMPExecutor  # noqa: E402

D = 4
PLAN = ExecPlan(heads=(6, 4, 4, 2), columns=(24, 16, 16, 8), head_dim=2,
                d_model=32, seq_shares=(3.0, 2.0, 2.0, 1.0))
#: (s, backend, overlap, transport, double_buffer) of every layer case
LAYER_CASES = list(itertools.product((16, 13), ("eager", "kernel"), (False, True),
                                     ("padded", "bucketed"), (False, True)))
#: the engine's scheduling modes: continuous, prefix cache + chunks, waves
ENGINE_MODES = {
    "continuous": dict(scheduler="continuous"),
    "prefix_chunked": dict(scheduler="continuous", prefix_cache=True, prefill_chunk=8),
    "wave": dict(scheduler="wave"),
}
#: the speculative cases' draft device (not 0, so a root fixed at 0 shows)
DRAFT_DEVICE = 2
#: the draft: reduced qwen1.5-0.5b (weights from the test process)
DRAFT_ARCH = "qwen1.5-0.5b"
#: the speculative engine's arguments (those of ``tests/test_torch_spec.py``)
SPEC_KW = dict(max_batch=2, max_len=40, scheduler="continuous", page_size=8, spec_k=4)


def _tick_clock():
    """A clock that advances one microsecond per read."""
    n = itertools.count()
    return lambda: next(n) * 1e-6


def _device_vals(shape=(1, 3, 5)):
    """Device i's test tensor, the same on every process."""
    base = torch.arange(float(np.prod(shape))).reshape(shape)
    return [base * (i + 1) + 0.25 * i for i in range(D)]


def primitives(ring, rank, local):
    vals = _device_vals()
    mine = [vals[rank]]
    out = {}
    partial = [(0, 1), (2, 3)]  # ranks 0 and 2 receive nothing
    out["permute_partial"] = (ring.permute(mine, partial)[0],
                              local.permute(vals, partial)[rank])
    ring_pairs = [(i, (i + 1) % D) for i in range(D)]
    posted = ring.permute_start(mine, ring_pairs)
    busy = mine[0] @ mine[0].transpose(1, 2)  # work while the hop is in flight
    out["permute_async"] = (posted.wait()[0] + 0 * busy.sum(),
                            local.permute(vals, ring_pairs)[rank])
    out["psum"] = (ring.psum(mine), local.psum(vals))
    out["all_gather"] = (ring.all_gather(mine, dim=1), local.all_gather(vals, dim=1))
    ids = torch.tensor([rank, 7 * rank + 1])
    out["agree"] = (ring.agree(ids), torch.tensor([0, 1]))
    out["agree_src"] = (ring.agree(ids, src=2), local.agree(torch.tensor([2, 15]), src=2))
    # bucketed segments where some ranks neither send nor receive
    sched = RingSchedule.ragged([3, 2, 2, 1], pad_tile=3, transport="bucketed",
                                bucket_grain=1)
    tiles = _device_vals((1, 3, 4))
    got, want = [], []
    for hop in range(D - 1):
        got.append(sched.ship([tiles[rank]], ring, hop)[0])
        want.append(sched.ship(tiles, local, hop)[rank])
    out["bucketed_ship"] = (torch.stack(got), torch.stack(want))
    return out


def layers(ring, rank, local, inp):
    (p,), _ = hmp.params_from_numpy([{k[6:]: inp[k] for k in inp if k.startswith("layer/")}],
                                    np.zeros((1, 32)))
    out = {}
    for s, backend, overlap, transport, db in LAYER_CASES:
        x = torch.from_numpy(inp[f"x{s}"])
        plan = PLAN.with_backend(backend).with_transport(transport, double_buffer=db)
        xp = plan.seq_layout(s).scatter(x)
        y = hmp.hmp_layer(p, xp, ring, plan=plan, overlap=overlap, seq=s)
        yl = (hmp.hmp_layer(p, xp, local, plan=plan, overlap=overlap, seq=s)
              if rank == 0 else None)
        out[(s, backend, overlap, transport, db)] = (y, yl)
    x = torch.from_numpy(inp["x16"])
    base = {"megatron_uneven_eager": lambda r: hmp.megatron_layer(p, x, r, plan=PLAN),
            "megatron_uneven_kernel": lambda r: hmp.megatron_layer(
                p, x, r, plan=PLAN.with_backend("kernel")),
            "megatron_even": lambda r: hmp.megatron_layer(p, x, r),
            "sp": lambda r: hmp.sp_layer(p, x, r)}
    for name, fn in base.items():
        out[name] = (fn(ring), fn(local) if rank == 0 else None)
    return out


def engines(ring, rank, local, inp):
    n = int(inp["n_stack"])
    stack = [{k.split("/", 1)[1]: inp[k] for k in inp if k.startswith(f"stack{i}/")}
             for i in range(n)]
    lt, et = hmp.params_from_numpy(stack, inp["emb"])
    prompts = [list(map(int, inp[f"prompt{i}"])) for i in range(int(inp["n_prompts"]))]
    out = {}
    for backend in ("eager", "kernel"):
        for mode, kw in ENGINE_MODES.items():
            res = {}
            for name, r in (("process", ring), ("local", local)):
                if name == "local" and rank != 0:
                    continue
                ex = GalaxyHMPExecutor(lt, et, PLAN.with_backend(backend), r)
                eng = ServingEngine(ex, max_batch=3, max_len=40, page_size=8, **kw)
                for i, pr in enumerate(prompts):
                    eng.submit(Request(uid=i, prompt=list(pr), max_new_tokens=3 + i))
                done = {q.uid: q.output for q in eng.run()}
                if eng.pool is not None:
                    eng.pool.check()
                res[name] = {"tokens": done, "stats": dict(eng.stats),
                             "layer_shards": len(ex.layers[0]),
                             "pool_shards": len(ex.make_pool(2, 8)[0]["k"])}
            out[(backend, mode)] = res
    return out


def _spec_inputs(inp):
    """The speculative cases' target weights, draft tree and requests."""
    n = int(inp["spec_n_stack"])
    stack = [{k.split("/", 1)[1]: inp[k] for k in inp if k.startswith(f"spec_stack{i}/")}
             for i in range(n)]
    lt, et = hmp.params_from_numpy(stack, inp["spec_emb"])
    tree: dict = {}
    for key in inp:
        if key.startswith("draft/"):
            *path, leaf = key.split("/")[1:]
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = inp[key]
    reqs = [(list(map(int, inp[f"spec_prompt{i}"])), int(inp["spec_max_new"][i]))
            for i in range(len(inp["spec_max_new"]))]
    return lt, et, tree, reqs


def _spec_engine(ring, holds_draft, lt, et, tree, backend, **kw):
    """A speculative engine over the Galaxy target on ``ring``; the draft
    executor only where ``holds_draft``."""
    draft = (TransformerExecutor(params_from_numpy(tree), reduced(get_config(DRAFT_ARCH)))
             if holds_draft else None)
    ex = GalaxyHMPExecutor(lt, et, PLAN.with_backend(backend), ring)
    return ServingEngine(ex, draft_executor=draft, draft_device=DRAFT_DEVICE,
                         **SPEC_KW, **kw)


def _serve(eng, reqs):
    for i, (prompt, max_new) in enumerate(reqs):
        eng.submit(Request(uid=i, prompt=list(prompt), max_new_tokens=max_new))
    return {q.uid: q.output for q in eng.run()}


def spec_serves(ring, rank, local, inp):
    """The uneven Galaxy spec case of ``tests/test_torch_spec.py`` with the
    draft on device ``DRAFT_DEVICE``'s rank, both pools checked after
    every round (a failed check is recorded, not raised, so the ranks stay
    in step), in both backends."""
    lt, et, tree, reqs = _spec_inputs(inp)
    orig = eng_mod.run_spec_round
    log = {"rounds": 0, "errors": []}

    def checked(engine, spec, slots, live, pool, storage):
        out = orig(engine, spec, slots, live, pool, storage)
        log["rounds"] += 1
        for what, p in (("pool", pool), ("draft pool", None if spec is None else spec.pool)):
            try:
                if p is not None:
                    p.check()
            except AssertionError as e:
                log["errors"].append(f"round {log['rounds']} {what}: {e}")
        return out

    eng_mod.run_spec_round = checked
    out = {}
    try:
        for backend in ("eager", "kernel"):
            res = {}
            for name, r, holds in (("process", ring, rank == DRAFT_DEVICE),
                                   ("local", local, True)):
                if name == "local" and rank != 0:
                    continue
                log.update(rounds=0, errors=[])
                eng = _spec_engine(r, holds, lt, et, tree, backend)
                done = _serve(eng, reqs)
                spec = eng.spec
                res[name] = {"tokens": done, "stats": dict(eng.stats),
                             "rounds": log["rounds"], "errors": list(log["errors"]),
                             "free": eng.pool.free_pages == eng.pool.num_pages - 1,
                             "draft": None if spec is None else {
                                 "prefills": spec.prefills, "steps": spec.steps,
                                 "free": spec.pool.free_pages == spec.pool.num_pages - 1}}
            out[backend] = res
    finally:
        eng_mod.run_spec_round = orig
    return out


def telemetry_serves(ring, rank, local, inp):
    """The spec case with chunks of 8, traced under a tick clock and drift
    priced by a constant pricer: on the ring rank 0 alone holds the tracer
    and the monitor; rank 0 runs the same on ``LocalRing``."""
    lt, et, tree, reqs = _spec_inputs(inp)
    out = {}
    for name, r, holds, first in (("process", ring, rank == DRAFT_DEVICE, rank == 0),
                                  ("local", local, True, True)):
        if name == "local" and rank != 0:
            continue
        tracer = Tracer(clock=_tick_clock()) if first else None
        drift = DriftMonitor(lambda kind, *, rows, context: 1e-3) if first else None
        eng = _spec_engine(r, holds, lt, et, tree, "kernel", prefill_chunk=8,
                           tracer=tracer, drift=drift, record_times=True)
        done = _serve(eng, reqs)
        out[name] = {
            "tokens": done, "stats": dict(eng.stats),
            "counters": eng.metrics.snapshot()["counters"],
            "events": None if tracer is None else tracer.events,
            "open_spans": None if tracer is None else tracer.open_spans(),
            "drift": None if drift is None else [
                {k: d[k] for k in ("kind", "rows", "context", "simulated_s")}
                for d in drift.records],
            "ttft_n": eng.metrics.snapshot()["histograms"]["ttft_s"]["n"]}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("inputs")
    ap.add_argument("out")
    ranks.add_rank_args(ap)
    args = ap.parse_args()
    ring, _ = ranks.init(args.rank, D, args.init_method, device="cpu", timeout=60)
    torch.set_num_threads(1)  # a CPU GEMM's bits can depend on the thread count
    inp = dict(np.load(args.inputs))
    local = LocalRing(D)
    res = {"primitives": primitives(ring, args.rank, local),
           "layers": layers(ring, args.rank, local, inp),
           "engines": engines(ring, args.rank, local, inp),
           "spec": spec_serves(ring, args.rank, local, inp),
           "telemetry": telemetry_serves(ring, args.rank, local, inp),
           "hops": ring.hops, "routes": dict(ring.routes)}
    torch.save(res, Path(args.out) / f"rank{args.rank}.pt")
    ranks.finish()


if __name__ == "__main__":
    sys.exit(main())
