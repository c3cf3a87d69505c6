"""Where the serve time goes: a serving run under ``torch.profiler``.

  PYTHONPATH=src python -m repro_torch.launch.trace_serve --model gpt2-l \\
      --capacities 3,2,2,1 --requests 4 --prompt-len 37-300 --max-new 8
  PYTHONPATH=src python -m repro_torch.launch.trace_serve --executor zoo \\
      --model recurrentgemma-9b --prompt-lens 300,300,300,300,2100,2100 \\
      --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.trace_serve --executor zoo \\
      --model stablelm-12b --requests 8 --prompt-len 64-512 \\
      --shared-prefix 1024 --prefix-cache on --prefill-chunk 256 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.trace_serve --executor zoo \\
      --model olmoe-1b-7b --requests 8 --prompt-len 64-512 \\
      --shared-prefix 1024 --prefix-cache on --prefill-chunk 256 --max-new 16

Builds the same executor as ``launch.serve`` (random weights from
``--seed``; ``--cuda-graphs`` as there: the decode steps, one-shot
prefills, prefill chunks and wave steps replayed as captured CUDA
graphs, bound to the pool and wave caches the executor holds, so they
outlive each serve) and serves the same requests three times on it: once
to build and warm the kernels (and capture), once unprofiled for the wall
time, and once under the profiler for the device time by kernel; with
``--cuda-graphs`` the last two replay what the earlier serves captured,
and the graph stats of both are printed.  Prints the wall times, the
device-busy time and its share of each wall time, the kernels that took
the most device time, and the PyTorch operators whose own launches took
the most (an operator's self device time, so an ``aten::einsum`` counts
the ``aten::bmm`` under it apart; the hand-written kernels launch
outside any operator and show only as kernels).  The profiler adds host time, so the idle
share against the profiled wall is an upper bound; the share against the
unprofiled wall is the closer estimate.  Runs on ``cuda`` unless
``--device cpu`` is given (where no device time is recorded).
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.launch.serve import (
    EXECUTORS,
    add_scheduling_args,
    parse_prompt_len,
    parse_prompt_lens,
    scheduling_kwargs,
    serve,
)


def trace(model: str = "gpt2-l", capacities: Sequence[float] = (3, 2, 2, 1), *,
          executor_kind: str = "galaxy", requests: int = 4,
          prompt_len: Tuple[int, int] = (37, 300),
          prompt_lens: Optional[Sequence[int]] = None,
          max_new: int = 8, max_batch: int = 4, device=None,
          dtype: Optional[str] = None, seed: int = 1, reduce: bool = False,
          graphs: bool = False, **scheduling) -> Dict:
    """Serve warm, then unprofiled, then profiled; return the wall times,
    device-busy ms, the profiler's device-side events, the unprofiled
    run's engine stats and the graph stats of the unprofiled and the
    profiled runs (each run's own).  ``scheduling`` takes ``serve``'s
    scheduler, page-size, prefix-cache, prefill-chunk, shared-prefix,
    temperature and draft arguments; ``graphs`` is ``serve``'s."""
    from torch.profiler import ProfilerActivity, profile

    kw = dict(executor_kind=executor_kind, requests=requests, prompt_len=prompt_len,
              prompt_lens=prompt_lens, max_new=max_new, max_batch=max_batch,
              device=device, dtype=dtype, seed=seed, reduce=reduce, graphs=graphs,
              **scheduling)
    warm = serve(model, capacities, **kw)
    kw.update(executor=warm["executor"], draft_executor=warm["draft_executor"])
    plain = serve(model, capacities, **kw)
    activities = [ProfilerActivity.CPU]
    if plain["executor"].device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        traced = serve(model, capacities, **kw)
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    return {
        "plan": plain["plan"],
        "wall_ms": 1e3 * plain["seconds"],
        "profiled_wall_ms": 1e3 * traced["seconds"],
        "busy_ms": sum(e.device_time_total for e in kernels) / 1e3,
        "kernels": sorted(kernels, key=lambda e: -e.device_time_total),
        "ops": sorted(ops, key=lambda e: -e.self_device_time_total),
        "stats": plain["stats"],
        "graph_stats": plain["graph_stats"],
        "profiled_graph_stats": traced["graph_stats"],
        "ttft_p50_ms": 1e3 * plain["ttft_p50_s"],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--executor", choices=EXECUTORS, default="galaxy")
    ap.add_argument("--model", default="gpt2-l")
    ap.add_argument("--capacities", default="3,2,2,1",
                    help="relative capacity of each edge device")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=parse_prompt_len, default=(37, 300),
                    metavar="LO-HI", help="prompt lengths, drawn uniformly")
    ap.add_argument("--prompt-lens", type=parse_prompt_lens, default=None,
                    metavar="N,N,...", help="one prompt length per request")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    ap.add_argument("--dtype", choices=("float16", "bfloat16", "float32"), default=None,
                    help="default: the model's serving dtype")
    ap.add_argument("--reduce", action="store_true",
                    help="the model's small variant (configs.reduced), e.g. on the CPU")
    ap.add_argument("--top", type=int, default=10,
                    help="kernels and operators to list, by device time")
    ap.add_argument("--cuda-graphs", action="store_true",
                    help="as launch.serve's: decode steps, one-shot prefills, prefill "
                         "chunks and wave steps replayed as captured CUDA graphs, held "
                         "across the three serves; on the card")
    add_scheduling_args(ap)
    args = ap.parse_args(argv)
    if args.cuda_graphs and args.device == "cpu":
        raise SystemExit("--cuda-graphs needs the card: --device cpu runs each step "
                         "eagerly")
    out = trace(args.model, [float(c) for c in args.capacities.split(",")],
                executor_kind=args.executor, requests=args.requests,
                prompt_len=args.prompt_len, prompt_lens=args.prompt_lens,
                max_new=args.max_new, max_batch=args.max_batch,
                device=args.device, dtype=args.dtype, seed=args.seed,
                reduce=args.reduce, graphs=args.cuda_graphs, **scheduling_kwargs(args))
    print(out["plan"])
    print(f"unprofiled run: TTFT p50 {out['ttft_p50_ms']:.1f} ms; stats {out['stats']}")
    if args.cuda_graphs:
        print(f"unprofiled run's graphs: {out['graph_stats']}")
        print(f"profiled run's graphs: {out['profiled_graph_stats']}")
    kernels, busy = out["kernels"], out["busy_ms"]
    n_req = len(args.prompt_lens) if args.prompt_lens else args.requests
    head = (f"{n_req} requests x {args.max_new} tokens: wall "
            f"{out['wall_ms']:.1f} ms unprofiled, {out['profiled_wall_ms']:.1f} ms "
            f"profiled")
    if not kernels:
        print(f"{head}; device busy: not measured (no device activity recorded)")
        return
    print(f"{head}; device busy {busy:.1f} ms in {sum(e.count for e in kernels)} "
          f"kernel launches; idle {100 * (1 - busy / out['wall_ms']):.1f}% of the "
          f"unprofiled wall, {100 * (1 - busy / out['profiled_wall_ms']):.1f}% of "
          f"the profiled wall")
    for e in kernels[:args.top]:
        print(f"  {e.device_time_total / 1e3:9.2f} ms {e.count:7d}x  {e.key[:90]}")
    print("operators by the device time of their own launches:")
    for e in out["ops"][:args.top]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d}x  {e.key[:90]}")


if __name__ == "__main__":
    main()
