"""Serve a paper model through a heterogeneity-aware Galaxy plan, or a
model of the zoo through the continuous scheduler or waves.

  PYTHONPATH=src python -m repro_torch.launch.serve --model gpt2-l \\
      --capacities 3,2,2,1 --requests 8 --prompt-len 37-300 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --executor zoo \\
      --model recurrentgemma-9b --prompt-lens 300,300,300,300,2100,2100 \\
      --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --executor zoo \\
      --model stablelm-12b --requests 8 --prompt-len 64-512 \\
      --shared-prefix 1024 --prefix-cache on --prefill-chunk 256 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --executor zoo \\
      --model olmoe-1b-7b --requests 8 --prompt-len 64-512 \\
      --shared-prefix 1024 --prefix-cache on --prefill-chunk 256 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --executor zoo \\
      --model xlstm-350m --prompt-lens 256,256,256,256,300,300 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --model gpt2-l \\
      --draft-model distilbert --spec-k 4 --requests 4 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --model gpt2-l \\
      --capacities 3,2,2,1 --ranks 4 --requests 8 --prompt-len 37-300
  PYTHONPATH=src python -m repro_torch.launch.serve --executor zoo \\
      --model recurrentgemma-9b --ranks 4 --prompt-lens 300,300,300,300,2100,2100
  PYTHONPATH=src python -m repro_torch.launch.serve --executor zoo \\
      --model stablelm-12b --ranks 4 --requests 8 --prompt-len 64-512 \\
      --shared-prefix 1024 --prefix-cache on --prefill-chunk 256 --max-new 16

``--executor galaxy`` (the default): profiler -> planner (Alg. 1) ->
``ExecPlan.from_plan`` -> Galaxy HMP executor on a ring of one device per
capacity -> the continuous-batching engine.  The cluster is ``len(capacities)`` edge
devices of ``c * 7.1`` GFLOP/s, ``c * 4`` GB/s memory and a 4 GB weight
budget each, joined by 1 Gbit/s links; the planner splits heads, MLP
columns and the sequence unevenly over them.  Weights are random, drawn
from ``--seed``; prompts are random token ids with lengths drawn from
``--prompt-len`` (or given one per request by ``--prompt-lens``).

``--executor zoo``: the model zoo (``models/``) at the model's full width
and depth, weights drawn on the device from ``--seed``, behind
``TransformerExecutor``.  ``--scheduler auto`` (the default) serves the
full-causal attention stacks (qwen1.5, codeqwen1.5, stablelm and the MoE
stacks olmoe and granite-moe) by continuous batching over the paged pool,
and RecurrentGemma and xLSTM in waves of same-length prompts (recurrent
and windowed caches are not pages).
``--prefix-cache on`` shares page-aligned prompt prefixes through the
radix-tree prefix cache and ``--prefill-chunk N`` interleaves N-token
prefill chunks with decode steps (continuous scheduler only).  With the
prefix cache on, every request's prompt is a shared system prompt of
``--shared-prefix`` random tokens (default: half the longest drawn
prompt, the reference's split) ahead of its own drawn tail.  ``--reduce``
serves the model's small variant (``configs.reduced``), for CPU runs.  A
model whose weights do not fit one card (qwen1.5-110b) is refused; the
count includes the padded vocabulary and experts.  The stubbed-frontend
archs are refused: musicgen-medium takes frame embeddings, not token ids
(as the reference's serve refuses it), and serving feeds no image
embeddings to llama-3.2-vision-90b; both train through ``launch.train``.
Both executors take the prefix cache and chunks, and ``--scheduler
wave``.

``--trace OUT.json`` records request and engine spans and writes them as
Chrome trace-event JSON (``chrome://tracing``, ui.perfetto.dev);
``--metrics`` prints the metrics registry's snapshot and its Prometheus
text; ``--drift`` prices every executed step with the planner's simulator
(``core/simulator.make_step_pricer``: the Galaxy executor's own plan, a
zoo model as a one-device even plan, on Jetson Nano-L devices over
1 Gbit/s links) and prints the measured/simulated ratios per step kind.
Drift syncs the card once per prefill chunk; the tracer never syncs.

``--draft-model M --spec-k K``: speculative decoding (``serving/spec.py``,
greedy and continuous scheduler only).  The draft proposes K tokens per
round and the served model verifies them in one ``prefill_chunk``.  With
``--executor galaxy`` the draft is a model of the paper's table (e.g.
``distilbert``, whose vocabulary is GPT2-L's) on a one-device plan,
placed on the fastest device of the cluster (``place_draft``); with
``--executor zoo`` it is a zoo model.  Draft and served model must share
a vocabulary.  The draft's weights are drawn from ``--seed`` + 2.

``--ranks N`` runs the Galaxy executor's ring as N processes, one per
edge device (``core/ring.ProcessRing`` over gloo; N must be the plan's
device count): this process builds the kernels once, starts the ranks
(``launch/ranks.py``) and waits for them.  Each rank draws the weights
from ``--seed``, keeps its own layer and pool shards, and runs the same
engine; rank 0 prints the serve line.  Rank r runs on ``cuda:(r % cards)``
(or the CPU under ``--device cpu``).  A rank that fails or outlives
``--rank-timeout`` stops the others and fails the serve.  With
``--draft-model`` the draft lives on the rank of the device ``place_draft``
names (the serve line's ``draft_device``): only that rank builds it and
runs its prefills and proposals, and it broadcasts each round's proposals
to every rank, which all verify them.  ``--trace``, ``--metrics`` and
``--drift`` read rank 0's engine, the one every rank's engine moves in
step with: rank 0 alone traces, prices and prints.

``--executor zoo --ranks N`` serves the zoo under the HMP sharding rules
(``models/sharding.make_rules(mesh, "prefill")``) on a (data 1, model N)
``DeviceMesh`` over the N gloo ranks, with the scheduler one process
takes: the continuous scheduler over a paged pool for the full-causal
attention stacks (with ``--prefix-cache``, ``--prefill-chunk`` and
``--draft-model``), waves for the rest.  Each rank draws the weights from
``--seed`` but keeps only its shards, holds every page of the pool for
its own KV heads, runs the flash and RG-LRU scan kernels on its own heads
and recurrence columns, and takes rank 0's sampled ids; the draft lives
on rank 0 alone, a one-process zoo executor, and broadcasts each round's
proposals.  On CUDA the mesh's collectives go through pinned host memory
(``core/ring.stage_mesh_collectives``).  What one process refuses (the
continuous scheduler for RecurrentGemma or xLSTM) is refused before any
rank starts.
``--report DIR`` has each rank write ``DIR/rank<r>.json``: its served
tokens, kernel launches and paths, engine stats and registry counters,
the draft's device and (on its rank) the draft's calls, ring hops, the
bytes of its weights, its peak device memory, its staged collectives
and, on the continuous scheduler, its pool's pages and the bytes it
holds of them.

``--cuda-graphs`` replays each paged decode step of the served model (and
of the draft), each one-shot prefill (a prompt that fits one chunk, and
every draft prefill) and each prefill chunk (prefix-hit suffixes, chunks
of ``--prefill-chunk``, speculative verify chunks), and in waves
(``--scheduler wave``, or RecurrentGemma and xLSTM) each wave prefill and
wave decode step, as captured CUDA graphs, one a step shape
(``serving/graphs.py``, the reference's jitted decode step,
per-padded-length one-shot prefill, per-chunk-shape prefill and
per-wave-shape prefill and decode; off by default): a decode step is
captured on its first call, a one-shot prefill, chunk or wave prefill
shape on its second (its first runs eagerly) and replayed after, a
one-shot prefill at any length that pads to its shape, a chunk at any
offset, a wave decode step at any position; the same tokens as without
it.  The executor then holds one paged pool, zeroed in place for each
run, and one wave cache a wave batch size, reset in place for each wave,
which its graphs read, so a ``serve(executor=...)`` call after the first
replays what the earlier ones captured.  The serve line (and
``--report``) adds the run's own ``graph_stats`` (shapes first met,
captures, replays and capture ms of this run, and the graph pools'
bytes, for ``decode``, ``prefill``, ``chunk``, ``wave_decode`` and
``wave_prefill``; the held pool's and wave caches' bytes) for the served
model and the draft.  Only one process on the card
is captured: ``--cuda-graphs`` is refused with ``--ranks`` above 1 (the
zoo in waves across ranks among them) and with ``--device cpu``.

Runs on ``cuda`` unless ``--device cpu`` is given, and refuses to start
when CUDA is absent and the CPU was not asked for.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import (
    FRONTEND_STUB_MODELS,
    PAPER_MODELS,
    ZOO_MODELS,
    ModelConfig,
    get_config,
    reduced,
)
from repro_torch.core import costmodel, hmp
from repro_torch.core.execplan import COMPUTE_BACKENDS, ExecPlan
from repro_torch.core.profiler import AnalyticProfiler
from repro_torch.core.ring import MESH_STAGED, LocalRing, ProcessRing, Ring
from repro_torch.core.simulator import make_step_pricer
from repro_torch.kernels import ops
from repro_torch.launch import ranks as rank_procs
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.params import init_params, local_bytes, param_bytes
from repro_torch.models.sharding import make_rules
from repro_torch.obs import DriftMonitor, Tracer
from repro_torch.serving.engine import (Request, ServingEngine, TransformerExecutor,
                                        paged_capable)
from repro_torch.serving.galaxy import GalaxyHMPExecutor
from repro_torch.serving.graphs import stats_since
from repro_torch.serving.kvcache import make_cache
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.serving.spec import place_draft

EXECUTORS = ("galaxy", "zoo")
SCHEDULERS = ("auto", "continuous", "wave")

#: device memory of the one card the port serves on (H100 80GB): a model
#: whose weights alone exceed it waits for serving across cards
CARD_BYTES = 80e9

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
                   num_layers: Optional[int] = None,
                   ring: Optional[Ring] = None) -> GalaxyHMPExecutor:
    """Random weights from ``seed`` (normal * 0.02, drawn on ``device``) on
    ``ring`` (default: a ``LocalRing`` of ``plan.num_devices`` shards).  On
    a ``ProcessRing`` every rank draws the same weights and keeps only its
    own shards."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n = cfg.num_layers if num_layers is None else num_layers
    layers = hmp.init_stack_params(n, cfg.d_model, cfg.num_heads, cfg.d_ff,
                                   generator=gen, device=device, dtype=dtype)
    embed = (torch.randn(cfg.vocab_size, cfg.d_model, generator=gen,
                         device=device) * 0.02).to(dtype)
    return GalaxyHMPExecutor(layers, embed, plan,
                             LocalRing(plan.num_devices) if ring is None else ring)


def build_draft(executor_kind: str, model: str, *, device: torch.device,
                dtype: Optional[str] = None, seed: int = 0, reduce: bool = False):
    """The speculative draft, on ``device``, weights drawn from ``seed``.

    galaxy: a paper model on a one-device plan (the whole model on one
    shard, no ring hop), run for the cluster device ``draft_placement``
    names; zoo: a zoo model behind ``TransformerExecutor``."""
    cfg = get_config(model)
    if reduce:
        cfg = reduced(cfg)
    if executor_kind == "zoo":
        return build_zoo_executor(cfg, device=device, dtype=dtype, seed=seed)
    plan = ExecPlan.even(1, num_heads=cfg.num_heads, d_ff=cfg.d_ff,
                         head_dim=cfg.head_dim, d_model=cfg.d_model).with_backend("kernel")
    return build_executor(cfg, plan, device=device,
                          dtype=getattr(torch, dtype or cfg.dtype), seed=seed)


def draft_placement(executor_kind: str, capacities: Sequence[float]) -> int:
    """The cluster device the draft runs on: the fastest one
    (``place_draft``) under the Galaxy executor, the one device of the zoo."""
    return 0 if executor_kind == "zoo" else place_draft(cluster(capacities)[0])


def build_zoo_executor(cfg: ModelConfig, *, device: torch.device,
                       dtype: Optional[str] = None, seed: int = 0,
                       backend: str = "kernel", ranks: int = 1) -> TransformerExecutor:
    """The model zoo at ``cfg``'s width and depth, random weights drawn on
    ``device`` from ``seed`` (in ``dtype``, default the config's).  With
    ``ranks`` > 1 this process is one rank of a process group of that size
    (``launch/ranks.init``): the executor runs under the HMP rules
    (``make_rules(mesh, "prefill")``) on a (data 1, model ``ranks``) mesh
    over the group, and this rank draws every weight but keeps only its
    shards (``init_params(rules=)``)."""
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    rules = None
    if ranks > 1:
        rules = make_rules(make_mesh((1, ranks), ("data", "model"), device=device.type),
                           "prefill")
    params = init_params(cfg, generator=gen, device=device, rules=rules)
    return TransformerExecutor(params, cfg, backend=backend, rules=rules)


def make_requests(cfg: ModelConfig, n: int, prompt_len: Tuple[int, int],
                  max_new: int, seed: int, lens: Optional[Sequence[int]] = None,
                  shared_prefix: int = 0):
    """Requests of random token ids: one per length in ``lens``, or ``n``
    with lengths drawn uniformly from ``prompt_len`` (inclusive), each
    behind one shared system prompt of ``shared_prefix`` random tokens
    (drawn last, so the tails do not depend on it)."""
    rng = np.random.default_rng(seed)
    if lens is None:
        lens = rng.integers(prompt_len[0], prompt_len[1] + 1, size=n)
    tails = [rng.integers(0, cfg.vocab_size, size=int(s)).tolist() for s in lens]
    shared = rng.integers(0, cfg.vocab_size, size=shared_prefix).tolist()
    return [Request(uid=i, prompt=shared + tail, max_new_tokens=max_new)
            for i, tail in enumerate(tails)]


def make_drift(cfg: ModelConfig,
               executor: Union[GalaxyHMPExecutor, TransformerExecutor]) -> DriftMonitor:
    """A drift monitor pricing each served step on the simulated edge
    cluster: the Galaxy executor's own plan, a zoo executor as a
    one-device even plan, every device a Jetson Nano-L with a 4 GB budget,
    1 Gbit/s links."""
    if isinstance(executor, GalaxyHMPExecutor):
        eplan = executor.plan
    else:
        eplan = ExecPlan.even(1, num_heads=cfg.num_heads, d_ff=cfg.d_ff,
                              head_dim=cfg.head_dim, d_model=cfg.d_model)
    devices = [costmodel.jetson_nano("nano-l", 4.0) for _ in range(eplan.num_devices)]
    return DriftMonitor(make_step_pricer(eplan, cfg, devices, costmodel.mbps(1000)))


def describe_zoo(cfg: ModelConfig, scheduler: str) -> str:
    pattern = ",".join(cfg.block_pattern)
    experts = (f" x {cfg.num_experts} experts (top {cfg.experts_per_token})"
               if cfg.is_moe else "")
    return (f"{cfg.name}: {cfg.num_layers} layers ({cfg.num_groups} x [{pattern}] + "
            f"{len(cfg.tail_pattern)} tail), d {cfg.d_model}, {cfg.num_heads} heads on "
            f"{cfg.num_kv_heads} kv x {cfg.head_dim}, window {cfg.window}, lru "
            f"{cfg.lru_width}, d_ff {cfg.d_ff}{experts}, vocab {cfg.vocab_size}, "
            f"{cfg.dtype}; {scheduler} scheduler")


def refuse_frontend_stub(model: str) -> None:
    """Serving feeds token ids only: refuse the trainer's stubbed-frontend
    architectures, as the reference's serve does."""
    cfg = FRONTEND_STUB_MODELS.get(model)
    if cfg is None:
        return
    if cfg.input_mode != "token":
        raise ValueError(f"{model} is a stub-frontend arch ({cfg.input_mode} input); "
                         "serve the token archs")
    raise ValueError(f"{model} cross-attends to image embeddings, and serving feeds no "
                     "image embeddings; train it with launch.train")


def check_fits_one_card(cfg: ModelConfig, dtype: Optional[str]) -> None:
    """Refuse a model whose weights alone exceed one card's memory (the
    parameter tree's bytes: padded vocabulary and experts, norms, biases)."""
    dt = dtype or cfg.param_dtype
    need = param_bytes(dataclasses.replace(cfg, param_dtype=dt))
    if need > CARD_BYTES:
        raise ValueError(
            f"{cfg.name} needs {need / 1e9:.1f} GB of {dt} weights, more than one "
            f"card's {CARD_BYTES / 1e9:.0f} GB: it waits for serving across cards")


def refuse_across_ranks(executor_kind: str, cfg: ModelConfig, *, scheduler: str = "auto",
                        spec: bool = False, prefix_cache: bool = False,
                        prefill_chunk: Optional[int] = None) -> None:
    """Before any rank starts, what one process refuses too, later: the
    zoo's continuous scheduler on an arch it serves in waves (recurrent or
    windowed caches are not pages), and speculative decoding, the prefix
    cache and chunked prefill, which need the continuous scheduler, where
    the serve runs in waves (``--scheduler wave``, or such an arch)."""
    if executor_kind == "galaxy":
        return
    paged = paged_capable(cfg)
    if scheduler == "continuous" and not paged:
        raise ValueError(
            f"the zoo executor serves {cfg.name} in waves, across ranks as on one process: "
            f"the continuous scheduler needs the paged protocol, which recurrent and "
            f"windowed caches do not take")
    if (spec or prefix_cache or prefill_chunk) and (scheduler == "wave" or not paged):
        raise ValueError(f"speculative decoding, the prefix cache and chunked prefill need the "
                         f"zoo's continuous scheduler; {cfg.name} is served in waves here, "
                         f"across ranks as on one process")


def serve(model: str = "gpt2-l", capacities: Sequence[float] = (3, 2, 2, 1), *,
          executor_kind: str = "galaxy", requests: int = 8,
          prompt_len: Tuple[int, int] = (37, 300),
          prompt_lens: Optional[Sequence[int]] = None,
          max_new: int = 16, max_batch: int = 4, device=None,
          dtype: Optional[str] = None, seed: int = 0, reduce: bool = False,
          scheduler: str = "auto", page_size: int = 16, prefix_cache: bool = False,
          prefill_chunk: Optional[int] = None, shared_prefix: Optional[int] = None,
          executor: Optional[Union[GalaxyHMPExecutor, TransformerExecutor]] = None,
          draft_model: Optional[str] = None, spec_k: Optional[int] = None,
          draft_executor=None, temperature: float = 0.0,
          tracer: Optional[Tracer] = None, drift: bool = False,
          record_times: bool = True, compute_backend: str = "kernel",
          ring: Optional[ProcessRing] = None, graphs: bool = False) -> Dict:
    """Build (or take) the executor, serve random prompts and return the
    finished requests, throughput and latency figures, the engine's stats
    and prefix-cache stats, its pool, and the executor (whose weights a
    later call may reuse as ``executor=``).

    ``prompt_lens`` gives one prompt length per request; without it,
    ``requests`` lengths are drawn from ``prompt_len``.  ``shared_prefix``
    tokens of one system prompt go ahead of every prompt (default: half
    the longest drawn prompt when ``prefix_cache``, else none).  ``dtype``
    defaults to the model's serving dtype; ``reduce`` serves the model's
    small variant.  ``draft_model`` (or a built ``draft_executor``) with
    ``spec_k`` turns on speculative decoding; ``temperature`` 0 is
    greedy.  ``tracer`` records the serve's spans, ``drift`` prices each
    step (``make_drift``; the monitor is returned as ``"drift"``), and
    ``record_times`` stamps each token (TTFT, the latency histograms); the
    engine's registry is returned as ``"metrics"``.  ``compute_backend`` is
    the Galaxy executor's per-shard compute (``ExecPlan.compute_backend``):
    "kernel" runs the hand-written kernels, "eager" the padded plain
    versions.  ``ring`` (a ``ProcessRing``: this process is one rank of the
    Galaxy ring) serves this rank's shards; every rank calls ``serve``
    with the same arguments, and only the rank of the draft's device
    builds ``draft_model``.  ``graphs`` sets the executor's and the
    draft's ``graphs`` (a taken executor's too) where it differs: each
    paged decode step, one-shot prefill, prefill chunk, wave prefill and
    wave decode step replays a captured CUDA graph of its shape.  An
    executor taken with graphs already on keeps them, with its held pool
    and wave caches, so a second serve on it replays what the first
    captured.  ``"graph_stats"`` holds this run's own
    (``{"target": ..., "draft": ...}``, None where off: the shapes first
    met, captures, replays and capture ms of this run, the graph pools'
    and held caches' bytes as they stand after it; both sides' are the
    one executor's where it drafts for itself)."""
    dev = resolve_device(device)
    if graphs and (ring is not None or dev.type != "cuda"):
        where = "across ranks" if ring is not None else f"on {dev.type}"
        raise ValueError("graphs=True captures one process's steps on the card, "
                         f"not {where}")  # checked before any weight is drawn
    if compute_backend != "kernel" and executor_kind != "galaxy":
        raise ValueError("compute_backend selects the Galaxy executor's per-shard compute; "
                         f"the {executor_kind} executor has none")
    if executor_kind not in EXECUTORS:
        raise ValueError(f"unknown executor {executor_kind!r}; one of {EXECUTORS}")
    refuse_frontend_stub(model)
    known = PAPER_MODELS if executor_kind == "galaxy" else ZOO_MODELS
    if model not in known:
        raise ValueError(f"the {executor_kind} executor serves {sorted(known)}, "
                         f"not {model!r}")
    if scheduler not in SCHEDULERS:
        raise ValueError(f"unknown scheduler {scheduler!r}; one of {SCHEDULERS}")
    cfg = get_config(model)
    if reduce:
        cfg = reduced(cfg)
    elif executor is None:
        check_fits_one_card(cfg, dtype)
    if ring is not None:
        refuse_across_ranks(executor_kind, cfg, scheduler=scheduler, spec=spec_k is not None,
                            prefix_cache=prefix_cache, prefill_chunk=prefill_chunk)
    if (draft_model is None and draft_executor is None) != (spec_k is None):
        raise ValueError("a draft model and spec_k go together")
    draft_device = None
    if draft_executor is None and draft_model is not None:
        known_draft = PAPER_MODELS if executor_kind == "galaxy" else ZOO_MODELS
        if draft_model not in known_draft:
            raise ValueError(f"the {executor_kind} executor drafts with "
                             f"{sorted(known_draft)}, not {draft_model!r}")
        dcfg = reduced(get_config(draft_model)) if reduce else get_config(draft_model)
        if dcfg.vocab_size != cfg.vocab_size:
            raise ValueError(f"draft {dcfg.name} vocab {dcfg.vocab_size} != target "
                             f"vocab {cfg.vocab_size}")
        draft_device = draft_placement(executor_kind, capacities)
        if ring is None or draft_device in ring.devices:
            draft_executor = build_draft(executor_kind, draft_model, device=dev,
                                         dtype=dtype, seed=seed + 2, reduce=reduce)
    if executor is None:
        if executor_kind == "galaxy":
            plan = build_plan(cfg, capacities, compute_backend=compute_backend)
            if ring is not None and ring.num_devices != plan.num_devices:
                raise ValueError(f"the plan has {plan.num_devices} devices but the ring "
                                 f"has {ring.num_devices} ranks")
            executor = build_executor(cfg, plan, device=dev,
                                      dtype=getattr(torch, dtype or cfg.dtype),
                                      seed=seed, ring=ring)
        else:
            executor = build_zoo_executor(cfg, device=dev, dtype=dtype, seed=seed,
                                          ranks=1 if ring is None else ring.num_devices)
    for ex in (executor, draft_executor):
        if ex is not None and ex.graphs != graphs:
            ex.graphs = graphs  # a new StepGraph: set only where it changes
    before = (executor.graph_stats, getattr(draft_executor, "graph_stats", None))
    max_prompt = prompt_len[1] if prompt_lens is None else max(prompt_lens)
    if shared_prefix is None:
        shared_prefix = max_prompt // 2 if prefix_cache else 0
    reqs = make_requests(cfg, requests, prompt_len, max_new, seed, lens=prompt_lens,
                         shared_prefix=shared_prefix)
    monitor = make_drift(cfg, executor) if drift else None
    engine = ServingEngine(executor=executor, max_batch=max_batch,
                           max_len=shared_prefix + max_prompt + max_new,
                           record_times=record_times, scheduler=scheduler,
                           page_size=page_size, prefix_cache=prefix_cache,
                           prefill_chunk=prefill_chunk,
                           sampler=SamplerConfig(temperature=temperature),
                           draft_executor=draft_executor, spec_k=spec_k,
                           draft_device=draft_device, tracer=tracer, drift=monitor)
    for r in reqs:
        engine.submit(r)
    t0 = time.perf_counter()
    done = engine.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    new_tokens = sum(len(r.output) for r in done)
    ttft = [r.token_times[0] - r.submit_time for r in done if r.token_times]
    resolved = scheduler
    if resolved == "auto":
        resolved = "continuous" if executor.supports_paged else "wave"
    return {
        "plan": (executor.plan.describe() if executor_kind == "galaxy"
                 else describe_zoo(executor.cfg, resolved)),
        "ranks": 1 if ring is None else ring.num_devices,
        "transport": "local" if ring is None else ring.transport,
        "requests": sorted(done, key=lambda r: r.uid),
        "seconds": seconds,
        "new_tokens": new_tokens,
        "tokens_per_s": new_tokens / seconds,
        "ttft_p50_s": float(np.median(ttft)) if ttft else float("nan"),
        "stats": dict(engine.stats),
        "metrics": engine.metrics,
        "drift": monitor,
        "prefix_stats": engine.prefix_stats,
        "pool": engine.pool,
        "executor": executor,
        "draft_executor": draft_executor,
        "draft_device": draft_device,
        "spec": engine.spec,
        "graph_stats": {"target": stats_since(before[0], executor.graph_stats),
                        "draft": None if draft_executor is None
                        else stats_since(before[1], draft_executor.graph_stats)},
    }


def write_report(directory: str, out: Dict, rank: int) -> None:
    """``directory/rank<rank>.json``: what this process served (tokens by
    request), its kernel launches and paths since the serve began, the
    engine's stats and its registry's counters, the draft's device and,
    where this process holds the draft, its prefill and decode calls, its
    ring's hops, the bytes of the weights it holds, its peak device memory
    and the mesh collectives it staged through host memory (calls and
    bytes sent, by collective), the zoo kernels' distinct calls
    (``kernels/ops.call_log``), the continuous scheduler's pool
    (``pool_report``) and the captured steps' ``graph_stats``."""
    ex = out["executor"]
    ring = getattr(ex, "ring", None)
    spec = out["spec"]
    os.makedirs(directory, exist_ok=True)
    rep = {"rank": rank, "ranks": out["ranks"], "transport": out["transport"],
           "tokens": {r.uid: r.output for r in out["requests"]},
           "launches": ops.launch_counts(), "paths": ops.path_counts(),
           "stats": out["stats"], "counters": out["metrics"].snapshot()["counters"],
           "draft_device": out["draft_device"],
           "draft": None if spec is None else {"prefills": spec.prefills,
                                               "steps": spec.steps},
           "seconds": out["seconds"], "tokens_per_s": out["tokens_per_s"],
           "ttft_p50_s": out["ttft_p50_s"],
           "hops": getattr(ring, "hops", 0), "hop_bytes": getattr(ring, "hop_bytes", 0),
           "routes": getattr(ring, "routes", {}),
           "weight_bytes": (local_bytes(ex.params)
                            if isinstance(ex, TransformerExecutor) else None),
           "peak_memory_bytes": (torch.cuda.max_memory_allocated()
                                 if torch.cuda.is_initialized() else None),
           "staged_collectives": {k: list(v) for k, v in MESH_STAGED.items()},
           "kernel_calls": ops.call_log(), "pool": pool_report(ex, out["pool"]),
           "graph_stats": out["graph_stats"]}
    with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
        json.dump(rep, f)


def pool_report(ex, pool) -> Optional[Dict]:
    """The continuous scheduler's pool as one rank holds it: its pages, the
    positions a page, and the bytes of this rank's shard of the zoo's
    pool storage (from its shapes; None for the Galaxy executor's)."""
    if pool is None:
        return None
    rep = {"pages": pool.num_pages, "page_size": pool.page_size, "bytes": None}
    if isinstance(ex, TransformerExecutor):
        rep["bytes"] = local_bytes(make_cache(ex.cfg, pool.num_pages, pool.page_size,
                                              abstract=True, rules=ex.rules))
    return rep


def launch_ranks(args, capacities: Sequence[float], argv) -> None:
    """``--ranks N``: check the request, build the kernels once, start the N
    ranks and wait for them (``SystemExit`` with a message if a rank fails
    or the ranks time out)."""
    cfg = get_config(args.model)
    if args.reduce:
        cfg = reduced(cfg)
    try:
        refuse_across_ranks(args.executor, cfg, scheduler=args.scheduler,
                            spec=args.spec_k is not None,
                            prefix_cache=args.prefix_cache == "on",
                            prefill_chunk=args.prefill_chunk)
    except ValueError as e:
        raise SystemExit(f"--ranks {args.ranks}: {e}")
    if args.executor == "galaxy":
        plan = build_plan(cfg, capacities, compute_backend=args.compute_backend)
        if plan.num_devices != args.ranks:
            raise SystemExit(f"--ranks {args.ranks} does not match the plan's "
                             f"{plan.num_devices} devices (--capacities {args.capacities})")
    if resolve_device(args.device).type == "cuda" and args.compute_backend == "kernel":
        from repro_torch.kernels import build
        build.build_all()  # once here, not once per rank
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        rank_procs.launch(rank_procs.python_module("repro_torch.launch.serve", argv),
                          args.ranks, timeout=args.rank_timeout)
    except rank_procs.RankFailure as e:
        raise SystemExit(f"serve --ranks {args.ranks} failed: {e}")


def parse_prompt_len(text: str) -> Tuple[int, int]:
    lo, _, hi = text.partition("-")
    return int(lo), int(hi or lo)


def parse_prompt_lens(text: str):
    return [int(n) for n in text.split(",")]


def add_scheduling_args(ap: argparse.ArgumentParser) -> None:
    """The engine's scheduling flags, with the reference's meaning."""
    ap.add_argument("--scheduler", choices=SCHEDULERS, default="auto",
                    help="auto = continuous batching when the executor has the "
                         "paged protocol, else waves")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV pool page size (continuous batching)")
    ap.add_argument("--prefix-cache", choices=("on", "off"), default="off",
                    help="shared-prefix KV cache: requests with a common "
                         "page-aligned prompt prefix map it to the same "
                         "refcounted pool pages and prefill only the uncached "
                         "suffix (continuous scheduler only)")
    ap.add_argument("--prefill-chunk", type=int, default=None, metavar="N",
                    help="chunked prefill: interleave N-token prefill chunks "
                         "with decode steps (continuous scheduler only)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--draft-model", default=None, metavar="MODEL",
                    help="speculative decoding (serving/spec.py): a small model "
                         "drafts --spec-k tokens per round on the fastest device "
                         "and the served model verifies them in one chunked "
                         "paged prefill (greedy only, continuous scheduler only); "
                         "galaxy: a paper model (distilbert), zoo: a zoo model")
    ap.add_argument("--spec-k", type=int, default=None, metavar="N",
                    help="draft tokens proposed per speculative round "
                         "(requires --draft-model)")
    ap.add_argument("--shared-prefix", type=int, default=None, metavar="N",
                    help="tokens of one shared system prompt ahead of every "
                         "prompt (default: half the longest prompt with "
                         "--prefix-cache on, else 0)")


def scheduling_kwargs(args) -> Dict:
    """The engine's scheduling arguments, after the reference's checks of
    the speculative flags (``SystemExit`` on a bad combination)."""
    if (args.draft_model is None) != (args.spec_k is None):
        raise SystemExit("--draft-model and --spec-k go together")
    if args.draft_model is not None:
        if args.scheduler == "wave":
            raise SystemExit(
                "--draft-model requires the continuous scheduler: the wave path has "
                "no paged chunk-prefill to verify drafts with (drop --scheduler wave)")
        if args.temperature != 0.0:
            raise SystemExit(
                "--draft-model is greedy-only: verification pins tokens to the "
                "sequential argmax path (drop --temperature)")
        target = get_config(args.model)
        draft = get_config(args.draft_model)
        if draft.vocab_size != target.vocab_size:
            raise SystemExit(f"draft {draft.name} vocab {draft.vocab_size} != target "
                             f"vocab {target.vocab_size}")
    return dict(scheduler=args.scheduler, page_size=args.page_size,
                prefix_cache=args.prefix_cache == "on",
                prefill_chunk=args.prefill_chunk, shared_prefix=args.shared_prefix,
                temperature=args.temperature, draft_model=args.draft_model,
                spec_k=args.spec_k)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--executor", choices=EXECUTORS, default="galaxy",
                    help="galaxy: a paper model through the HMP plan; zoo: a "
                         "zoo model (stablelm-12b, qwen1.5-0.5b, ..., "
                         "recurrentgemma-9b, olmoe-1b-7b, granite-moe-3b-a800m, "
                         "xlstm-350m)")
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
                         "the zoo bfloat16)")
    ap.add_argument("--reduce", action="store_true",
                    help="serve the model's small variant (configs.reduced), "
                         "e.g. for a CPU run")
    ap.add_argument("--compute-backend", choices=COMPUTE_BACKENDS, default="kernel",
                    help="Galaxy per-shard compute (ExecPlan.compute_backend): 'kernel' "
                         "sheds pad-block work through the hand-written kernels; 'eager' "
                         "is the padded plain oracle.  Galaxy executor only: the zoo "
                         "has no padded shards to shed")
    add_scheduling_args(ap)
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record request/engine spans and write Chrome trace-event "
                         "JSON (chrome://tracing, ui.perfetto.dev)")
    ap.add_argument("--metrics", action="store_true",
                    help="print the metrics registry snapshot (TTFT/ITL percentiles, "
                         "pool occupancy, hit/acceptance rates) and its Prometheus "
                         "text rendering")
    ap.add_argument("--drift", action="store_true",
                    help="price every executed step with the planner's simulator "
                         "(core/simulator.make_step_pricer) and report "
                         "measured/simulated drift ratios (syncs once per prefill "
                         "chunk)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="galaxy: processes of the ring, one per edge device "
                         "(core/ring.ProcessRing over gloo), equal to the plan's "
                         "device count; 1 holds every device in this process "
                         "(LocalRing).  zoo: ranks of the model axis of the HMP "
                         "rules' mesh")
    ap.add_argument("--rank-timeout", type=float, default=1800.0, metavar="S",
                    help="with --ranks: seconds the ranks may take in all")
    ap.add_argument("--report", default=None, metavar="DIR",
                    help="each rank writes DIR/rank<r>.json: served tokens, kernel "
                         "launches and paths, engine stats, ring hops; weights, peak "
                         "memory, staged collectives, (zoo) distinct kernel calls and "
                         "graph stats (the five step kinds, the held pool's and wave "
                         "caches' bytes)")
    ap.add_argument("--cuda-graphs", action="store_true",
                    help="replay each paged decode step, one-shot prefill and prefill "
                         "chunk, and each wave prefill and wave decode step (the served "
                         "model's and the draft's), as a captured CUDA graph of its "
                         "shape; one process on the card")
    rank_procs.add_rank_args(ap)
    args = ap.parse_args(argv)
    if args.cuda_graphs and args.ranks > 1:
        raise SystemExit(f"--cuda-graphs captures one process's steps; --ranks "
                         f"{args.ranks} hops through the host between ranks, which a "
                         "CUDA graph cannot hold")
    if args.cuda_graphs and args.device == "cpu":
        raise SystemExit("--cuda-graphs needs the card: --device cpu runs each "
                         "step eagerly")
    capacities = [float(c) for c in args.capacities.split(",")]
    sched = scheduling_kwargs(args)
    if args.ranks < 1:
        raise SystemExit(f"--ranks must be >= 1, got {args.ranks}")
    if args.ranks > 1 and args.rank is None:
        return launch_ranks(args, capacities, argv)
    ring = None
    device = args.device
    if args.rank is not None:
        ring, device = rank_procs.init(args.rank, args.ranks, args.init_method,
                                       device=args.device)
    # telemetry reads one engine's clock: rank 0's, every rank's engine
    # moving in step with it
    first = args.rank in (None, 0)
    tracer = Tracer() if args.trace is not None and first else None
    if args.report is not None:
        ops.reset_launch_counts()
        ops.reset_call_log()
    out = serve(args.model, capacities,
                executor_kind=args.executor, requests=args.requests,
                prompt_len=args.prompt_len, prompt_lens=args.prompt_lens,
                max_new=args.max_new, max_batch=args.max_batch,
                device=device, dtype=args.dtype, seed=args.seed,
                reduce=args.reduce, tracer=tracer, drift=args.drift and first,
                compute_backend=args.compute_backend, ring=ring,
                graphs=args.cuda_graphs, **sched)
    if args.report is not None:
        write_report(args.report, out, 0 if args.rank is None else args.rank)
    if args.rank is not None:
        rank_procs.finish()
    if not first:
        return
    print(out["plan"])
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("plan", "requests", "pool", "executor",
                                   "draft_executor", "spec", "metrics", "drift")}))
    if tracer is not None:
        tracer.write(args.trace)
        print(f"trace: {len(tracer.events)} events -> {args.trace}")
    if args.metrics:
        print("metrics snapshot:")
        print(json.dumps(out["metrics"].snapshot(), indent=2, default=float))
        print(out["metrics"].to_prometheus(), end="")
    if args.drift:
        print("sim-vs-measured drift (measured/simulated ratio):")
        for kind, s in out["drift"].summary().items():
            print(f"  {kind}: n={s['n']} p50={s['p50']:.2f} p95={s['p95']:.2f}")


if __name__ == "__main__":
    main()
