"""Time the Galaxy ring across processes: its hops, and the prefill of the
stack under the overlapped ring with and without double buffering and
under the unoverlapped (sync) schedule.

  PYTHONPATH=src python -m repro_torch.launch.ring_times --ranks 4
  PYTHONPATH=src python -m repro_torch.launch.ring_times --ranks 4 \\
      --device cpu --model gpt2-l --reduce

Each of the ``--ranks`` processes holds one device of the 3:2:2:1 plan
(``core/ring.ProcessRing`` over gloo) and the model's full depth at full
width unless ``--reduce``, weights from ``--seed``.  Rank 0 prints one
JSON line:

* ``hop``: one ring hop of a ``pad_tile`` x d_model tile of a
  ``--seq``-row prompt (the tile a padded-transport prefill ships), posted
  by every rank at once after a barrier and timed until the received tile
  is on this rank's device, ``HOPS`` times; each rank's median (ms), the
  bytes a rank sends, and the route (host-staged for CUDA tensors);
* ``prefill``: ``hmp_prefill`` of one ``--seq``-token prompt through the
  stack into a paged pool under each schedule of ``SCHEDULES``, in the
  order of ``ORDER`` ``REPEATS`` times, each behind a barrier and ended by
  a device synchronize: each rank's median (ms), and the kernel launches
  of one prefill of each schedule on each rank.  ``ring`` and
  ``ring_double_buffer`` differ only in whether a hop is in flight during
  the step's GEMMs; ``sync`` also moves other bytes (its reduce-scatter
  exits through ``psum``, an all-gather of every device's whole partial);
* the largest logit difference of each ring schedule from ``sync``.

On one card the ranks are CUDA contexts that the card time-slices: these
are not the times of D devices.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduced
from repro_torch.core import hmp
from repro_torch.kernels import ops
from repro_torch.launch import ranks as rank_procs
from repro_torch.launch.serve import build_executor, build_plan

#: hops timed per rank, and timed rounds of ``ORDER``
HOPS, REPEATS = 30, 2
SCHEDULES = ("ring", "ring_double_buffer", "sync")
#: a round runs each schedule once on the way out and once on the way back
ORDER = SCHEDULES + SCHEDULES[::-1]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, dev):
    dist.barrier()
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def rank_main(args) -> None:
    ring, dev = rank_procs.init(args.rank, args.ranks, args.init_method, device=args.device)
    cfg = get_config(args.model)
    if args.reduce:
        cfg = reduced(cfg)
    plan = build_plan(cfg, [float(c) for c in args.capacities.split(",")])
    if plan.num_devices != args.ranks:
        raise SystemExit(f"--ranks {args.ranks} != the plan's {plan.num_devices} devices")
    dtype = getattr(torch, args.dtype or cfg.dtype)
    ex = build_executor(cfg, plan, device=dev, dtype=dtype, seed=args.seed, ring=ring)
    seq, page = args.seq, 16
    layout = plan.seq_layout(seq)
    plans = {"ring": plan.with_transport(double_buffer=False),
             "ring_double_buffer": plan.with_transport(double_buffer=True),
             "sync": plan}

    # --- hops
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1 + args.rank)
    tile = torch.randn(1, layout.pad_tile, cfg.d_model, generator=gen, device=dev).to(dtype)
    pairs = [(i, (i + 1) % args.ranks) for i in range(args.ranks)]
    hop_s = []
    for n in range(3 + HOPS):
        _, s = _timed(lambda: ring.permute([tile], pairs), dev)
        if n >= 3:
            hop_s.append(s)

    # --- prefill under each schedule
    tokens = torch.randint(0, cfg.vocab_size, (1, seq), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(args.seed + 7))
    n_pages = -(-seq // page)
    row = torch.arange(1, 1 + n_pages, device=dev)
    pool = ex.make_pool(1 + n_pages, page)
    lay, x = ex._embed(tokens)

    def prefill(name):
        y, _ = hmp.hmp_prefill(ex.layers, x, ring, pool, plan=plans[name],
                               overlap=name != "sync", seq=seq, block_row=row)
        return lay.gather(y)

    launches, outs = {}, {}
    for name in SCHEDULES:  # warm, and count one prefill each
        ops.reset_launch_counts()
        outs[name] = prefill(name)
        _sync(dev)
        launches[name] = ops.launch_counts()
    times = {name: [] for name in SCHEDULES}
    for _ in range(REPEATS):
        for name in ORDER:
            times[name].append(_timed(lambda: prefill(name), dev)[1])
    logits = {k: (v[0, -1] @ ex.embed.T).float() for k, v in outs.items()}
    res = {"rank": args.rank, "device": str(dev),
           "hop_ms": 1e3 * float(np.median(hop_s)), "hop_ms_min": 1e3 * min(hop_s),
           "hop_bytes": tile.numel() * tile.element_size(),
           "routes": dict(ring.routes),
           "prefill_ms": {k: 1e3 * float(np.median(v)) for k, v in times.items()},
           "launches": launches,
           "logit_err_vs_sync": {k: (logits[k] - logits["sync"]).abs().max().item()
                                 for k in SCHEDULES if k != "sync"}}
    every = [None] * args.ranks
    dist.all_gather_object(every, res)
    if args.rank == 0:
        print(json.dumps({"model": cfg.name, "layers": len(ex.layers), "seq": seq,
                          "dtype": str(dtype).replace("torch.", ""), "ranks": args.ranks,
                          "pad_tile": layout.pad_tile, "per_rank": every}), flush=True)
    rank_procs.finish()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--model", default="gpt2-l")
    ap.add_argument("--capacities", default="3,2,2,1")
    ap.add_argument("--reduce", action="store_true")
    ap.add_argument("--dtype", choices=("float16", "bfloat16", "float32"), default=None)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    rank_procs.add_rank_args(ap)
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_main(args)
        return
    if args.device != "cpu":
        from repro_torch.kernels import build
        build.build_all()  # once here, not once per rank
    try:
        rank_procs.launch(rank_procs.python_module(
            "repro_torch.launch.ring_times", list(sys.argv[1:] if argv is None else argv)),
            args.ranks, timeout=args.timeout)
    except rank_procs.RankFailure as e:
        raise SystemExit(f"ring_times --ranks {args.ranks} failed: {e}")


if __name__ == "__main__":
    main()
