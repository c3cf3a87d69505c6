"""Serve a paper model through a heterogeneity-aware Galaxy plan.

  PYTHONPATH=src python -m repro_torch.launch.serve --model gpt2-l \\
      --capacities 3,2,2,1 --requests 8 --prompt-len 37-300 --max-new 16

Profiler -> planner (Alg. 1) -> ``ExecPlan.from_plan`` -> Galaxy HMP
executor on a single-process ring of one device per capacity -> the
continuous-batching engine.  The cluster is ``len(capacities)`` edge
devices of ``c * 7.1`` GFLOP/s, ``c * 4`` GB/s memory and a 4 GB weight
budget each, joined by 1 Gbit/s links; the planner splits heads, MLP
columns and the sequence unevenly over them.  Weights are random, drawn
from ``--seed``; prompts are random token ids with lengths drawn from
``--prompt-len``.  Runs on ``cuda`` unless ``--device cpu`` is given, and
refuses to start when CUDA is absent and the CPU was not asked for.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig, get_config
from repro_torch.core import costmodel, hmp
from repro_torch.core.execplan import ExecPlan
from repro_torch.core.profiler import AnalyticProfiler
from repro_torch.core.ring import LocalRing
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.galaxy import GalaxyHMPExecutor

#: the planning sequence length of the profiler (rows the SP axis splits)
PLAN_SEQ = 256


def cluster(capacities: Sequence[float]):
    """Edge devices of relative capacity ``c`` and their 1 Gbit/s links."""
    devs = [costmodel.DeviceSpec(f"edge{i}", flops=c * 7.1e9, mem_bw=c * 4e9,
                                 memory_budget=4e9)
            for i, c in enumerate(capacities)]
    return devs, [costmodel.mbps(1000)] * len(devs)


def build_plan(cfg: ModelConfig, capacities: Sequence[float], *,
               compute_backend: str = "kernel") -> ExecPlan:
    """Algorithm 1 over the cluster, materialized as an ExecPlan."""
    devs, links = cluster(capacities)
    plan = AnalyticProfiler(cfg, PLAN_SEQ).plan(devs, links=links)
    return ExecPlan.from_plan(plan, head_dim=cfg.head_dim, d_model=cfg.d_model,
                              compute_backend=compute_backend)


def build_executor(cfg: ModelConfig, plan: ExecPlan, *, device: torch.device,
                   dtype: torch.dtype, seed: int = 0,
                   num_layers: Optional[int] = None) -> GalaxyHMPExecutor:
    """Random weights from ``seed`` (normal * 0.02, drawn on ``device``) on
    a ring of ``plan.num_devices`` shards."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n = cfg.num_layers if num_layers is None else num_layers
    layers = hmp.init_stack_params(n, cfg.d_model, cfg.num_heads, cfg.d_ff,
                                   generator=gen, device=device, dtype=dtype)
    embed = (torch.randn(cfg.vocab_size, cfg.d_model, generator=gen,
                         device=device) * 0.02).to(dtype)
    return GalaxyHMPExecutor(layers, embed, plan, LocalRing(plan.num_devices))


def make_requests(cfg: ModelConfig, n: int, prompt_len: Tuple[int, int],
                  max_new: int, seed: int):
    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt_len[0], prompt_len[1] + 1, size=n)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=int(s)).tolist(),
                    max_new_tokens=max_new) for i, s in enumerate(lens)]


def serve(model: str = "gpt2-l", capacities: Sequence[float] = (3, 2, 2, 1), *,
          requests: int = 8, prompt_len: Tuple[int, int] = (37, 300),
          max_new: int = 16, max_batch: int = 4, device=None,
          dtype: Optional[str] = None, seed: int = 0,
          executor: Optional[GalaxyHMPExecutor] = None) -> Dict:
    """Build (or take) the executor, serve ``requests`` random prompts and
    return the finished requests, throughput and latency figures, and the
    executor (whose weights a later call may reuse as ``executor=``).
    ``dtype`` defaults to the model's serving dtype."""
    dev = resolve_device(device)
    cfg = get_config(model)
    if executor is None:
        plan = build_plan(cfg, capacities)
        executor = build_executor(cfg, plan, device=dev,
                                  dtype=getattr(torch, dtype or cfg.dtype),
                                  seed=seed)
    engine = ServingEngine(executor=executor, max_batch=max_batch,
                           max_len=prompt_len[1] + max_new, record_times=True)
    for r in make_requests(cfg, requests, prompt_len, max_new, seed):
        engine.submit(r)
    t0 = time.perf_counter()
    done = engine.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    new_tokens = sum(len(r.output) for r in done)
    ttft = [r.token_times[0] - r.submit_time for r in done if r.token_times]
    return {
        "plan": executor.plan.describe(),
        "requests": sorted(done, key=lambda r: r.uid),
        "seconds": seconds,
        "new_tokens": new_tokens,
        "tokens_per_s": new_tokens / seconds,
        "ttft_p50_s": float(np.median(ttft)) if ttft else float("nan"),
        "stats": dict(engine.stats),
        "executor": executor,
    }


def parse_prompt_len(text: str) -> Tuple[int, int]:
    lo, _, hi = text.partition("-")
    return int(lo), int(hi or lo)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="gpt2-l")
    ap.add_argument("--capacities", default="3,2,2,1",
                    help="relative capacity of each edge device")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=parse_prompt_len, default=(37, 300),
                    metavar="LO-HI", help="prompt lengths, drawn uniformly")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    ap.add_argument("--dtype", choices=("float16", "float32"), default=None,
                    help="default: the model's serving dtype (float16)")
    args = ap.parse_args(argv)
    out = serve(args.model, [float(c) for c in args.capacities.split(",")],
                requests=args.requests, prompt_len=args.prompt_len,
                max_new=args.max_new, max_batch=args.max_batch,
                device=args.device, dtype=args.dtype, seed=args.seed)
    print(out["plan"])
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("plan", "requests", "executor")}))


if __name__ == "__main__":
    main()
