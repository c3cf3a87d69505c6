"""Serve a paper model through a heterogeneity-aware Galaxy plan, or a
model of the zoo through the wave scheduler.

  PYTHONPATH=src python -m repro_torch.launch.serve --model gpt2-l \\
      --capacities 3,2,2,1 --requests 8 --prompt-len 37-300 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --executor zoo \\
      --model recurrentgemma-9b --prompt-lens 300,300,300,300,2100,2100 \\
      --max-new 16

``--executor galaxy`` (the default): profiler -> planner (Alg. 1) ->
``ExecPlan.from_plan`` -> Galaxy HMP executor on a single-process ring of
one device per capacity -> the continuous-batching engine.  The cluster is ``len(capacities)`` edge
devices of ``c * 7.1`` GFLOP/s, ``c * 4`` GB/s memory and a 4 GB weight
budget each, joined by 1 Gbit/s links; the planner splits heads, MLP
columns and the sequence unevenly over them.  Weights are random, drawn
from ``--seed``; prompts are random token ids with lengths drawn from
``--prompt-len`` (or given one per request by ``--prompt-lens``).

``--executor zoo``: the model zoo (``models/``) at the model's full width
and depth, weights drawn on the device from ``--seed``, behind
``TransformerExecutor``; recurrent and windowed caches are not pages, so
the engine serves it in waves of same-length prompts.  ``--reduce``
serves the model's small variant (``configs.reduced``), for CPU runs.

Runs on ``cuda`` unless ``--device cpu`` is given, and refuses to start
when CUDA is absent and the CPU was not asked for.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import PAPER_MODELS, ZOO_MODELS, ModelConfig, get_config, reduced
from repro_torch.core import costmodel, hmp
from repro_torch.core.execplan import ExecPlan
from repro_torch.core.profiler import AnalyticProfiler
from repro_torch.core.ring import LocalRing
from repro_torch.models.params import init_params
from repro_torch.serving.engine import Request, ServingEngine, TransformerExecutor
from repro_torch.serving.galaxy import GalaxyHMPExecutor

EXECUTORS = ("galaxy", "zoo")

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


def build_zoo_executor(cfg: ModelConfig, *, device: torch.device,
                       dtype: Optional[str] = None, seed: int = 0,
                       backend: str = "kernel") -> TransformerExecutor:
    """The model zoo at ``cfg``'s width and depth, random weights drawn on
    ``device`` from ``seed`` (in ``dtype``, default the config's)."""
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, generator=gen, device=device)
    return TransformerExecutor(params, cfg, backend=backend)


def make_requests(cfg: ModelConfig, n: int, prompt_len: Tuple[int, int],
                  max_new: int, seed: int, lens: Optional[Sequence[int]] = None):
    """Requests of random token ids: one per length in ``lens``, or ``n``
    with lengths drawn uniformly from ``prompt_len`` (inclusive)."""
    rng = np.random.default_rng(seed)
    if lens is None:
        lens = rng.integers(prompt_len[0], prompt_len[1] + 1, size=n)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=int(s)).tolist(),
                    max_new_tokens=max_new) for i, s in enumerate(lens)]


def describe_zoo(cfg: ModelConfig) -> str:
    pattern = ",".join(cfg.block_pattern)
    return (f"{cfg.name}: {cfg.num_layers} layers ({cfg.num_groups} x [{pattern}] + "
            f"{len(cfg.tail_pattern)} tail), d {cfg.d_model}, {cfg.num_heads} heads on "
            f"{cfg.num_kv_heads} kv x {cfg.head_dim}, window {cfg.window}, lru "
            f"{cfg.lru_width}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}; "
            f"wave scheduler")


def serve(model: str = "gpt2-l", capacities: Sequence[float] = (3, 2, 2, 1), *,
          executor_kind: str = "galaxy", requests: int = 8,
          prompt_len: Tuple[int, int] = (37, 300),
          prompt_lens: Optional[Sequence[int]] = None,
          max_new: int = 16, max_batch: int = 4, device=None,
          dtype: Optional[str] = None, seed: int = 0, reduce: bool = False,
          executor: Optional[Union[GalaxyHMPExecutor, TransformerExecutor]] = None) -> Dict:
    """Build (or take) the executor, serve random prompts and return the
    finished requests, throughput and latency figures, and the executor
    (whose weights a later call may reuse as ``executor=``).

    ``prompt_lens`` gives one prompt length per request; without it,
    ``requests`` lengths are drawn from ``prompt_len``.  ``dtype``
    defaults to the model's serving dtype; ``reduce`` serves the model's
    small variant."""
    dev = resolve_device(device)
    if executor_kind not in EXECUTORS:
        raise ValueError(f"unknown executor {executor_kind!r}; one of {EXECUTORS}")
    known = PAPER_MODELS if executor_kind == "galaxy" else ZOO_MODELS
    if model not in known:
        raise ValueError(f"the {executor_kind} executor serves {sorted(known)}, "
                         f"not {model!r}")
    cfg = get_config(model)
    if reduce:
        cfg = reduced(cfg)
    if executor is None:
        if executor_kind == "galaxy":
            plan = build_plan(cfg, capacities)
            executor = build_executor(cfg, plan, device=dev,
                                      dtype=getattr(torch, dtype or cfg.dtype),
                                      seed=seed)
        else:
            executor = build_zoo_executor(cfg, device=dev, dtype=dtype, seed=seed)
    reqs = make_requests(cfg, requests, prompt_len, max_new, seed, lens=prompt_lens)
    max_prompt = prompt_len[1] if prompt_lens is None else max(prompt_lens)
    engine = ServingEngine(executor=executor, max_batch=max_batch,
                           max_len=max_prompt + max_new, record_times=True)
    for r in reqs:
        engine.submit(r)
    t0 = time.perf_counter()
    done = engine.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    new_tokens = sum(len(r.output) for r in done)
    ttft = [r.token_times[0] - r.submit_time for r in done if r.token_times]
    return {
        "plan": (executor.plan.describe() if executor_kind == "galaxy"
                 else describe_zoo(executor.cfg)),
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


def parse_prompt_lens(text: str):
    return [int(n) for n in text.split(",")]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--executor", choices=EXECUTORS, default="galaxy",
                    help="galaxy: a paper model through the HMP plan; zoo: a "
                         "zoo model (recurrentgemma-9b) through waves")
    ap.add_argument("--model", default="gpt2-l",
                    help=f"galaxy: one of {sorted(PAPER_MODELS)}; zoo: one of "
                         f"{sorted(ZOO_MODELS)}")
    ap.add_argument("--capacities", default="3,2,2,1",
                    help="relative capacity of each edge device")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=parse_prompt_len, default=(37, 300),
                    metavar="LO-HI", help="prompt lengths, drawn uniformly")
    ap.add_argument("--prompt-lens", type=parse_prompt_lens, default=None,
                    metavar="N,N,...", help="one prompt length per request "
                    "(replaces --requests and --prompt-len)")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    ap.add_argument("--dtype", choices=("float16", "bfloat16", "float32"), default=None,
                    help="default: the model's serving dtype (gpt2-l float16, "
                         "recurrentgemma-9b bfloat16)")
    ap.add_argument("--reduce", action="store_true",
                    help="serve the model's small variant (configs.reduced), "
                         "e.g. for a CPU run")
    args = ap.parse_args(argv)
    out = serve(args.model, [float(c) for c in args.capacities.split(",")],
                executor_kind=args.executor, requests=args.requests,
                prompt_len=args.prompt_len, prompt_lens=args.prompt_lens,
                max_new=args.max_new, max_batch=args.max_batch,
                device=args.device, dtype=args.dtype, seed=args.seed,
                reduce=args.reduce)
    print(out["plan"])
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("plan", "requests", "executor")}))


if __name__ == "__main__":
    main()
