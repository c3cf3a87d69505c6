"""Serving engine: continuous batching over a paged KV pool, and waves.

Two schedulers share one engine:

* ``continuous`` — a fixed decode batch of ``max_batch`` *slots* over a
  shared :class:`~repro_torch.serving.kvpool.PagedKVPool`.  Requests are
  admitted from the queue the moment a slot frees (respecting pool
  capacity), prefill writes prompt KV straight into pool pages, every
  decode step advances all live slots at their own depths, and finished
  requests retire per-slot (EOS / max-len), returning their pages for
  reuse.  It needs the paged executor protocol (``make_pool`` /
  ``prefill_paged`` / ``decode_paged``); prompts pad to
  ``lcm(prompt_pad_multiple, page_size)``, so page-boundary padding costs
  no extra pages and bounds the number of distinct prefill shapes.
* ``wave`` — batch same-bucket prompts, prefill them together into a
  dense cache, decode in lockstep.  It needs the wave protocol
  (``make_cache`` / ``prefill`` / ``decode``), which every executor has.
  The model zoo's :class:`TransformerExecutor` pages full-causal
  attention stacks (the dense GQA archs) and serves the rest
  (RecurrentGemma: recurrent and sliding-window caches are not
  position-addressable pages) in waves.

``scheduler="auto"`` takes the continuous scheduler when the executor
supports the paged protocol, else waves.

Two continuous-scheduler extensions, as in the reference:

* **Shared-prefix KV cache** (``prefix_cache=True``): admission looks the
  prompt up in the radix tree of
  :class:`~repro_torch.serving.prefix_cache.PrefixCache`, attaches the
  hit's filled pages to the slot by refcount bump, and prefills only the
  uncached suffix (the executor's ``prefill_chunk`` at the cached
  offset).  The request's full prompt pages then enter the tree.
* **Chunked prefill** (``prefill_chunk=N``): admission queues a prefill
  task and the main loop runs one N-token (grain-rounded) chunk per
  iteration beside the decode step, so a long prompt does not stall the
  live decode slots.

and **speculative decoding** (``draft_executor=``, ``spec_k=``): a draft
executor proposes ``spec_k`` greedy tokens per live slot and the target
verifies them in one ``prefill_chunk`` (``serving/spec.py``).  On a ring
of processes only the rank of ``draft_device`` holds the draft; it
broadcasts each round's proposals and every rank verifies them.

Observability (``repro_torch.obs``): every engine owns a
:class:`~repro_torch.obs.metrics.MetricsRegistry` (``engine.metrics``) and
``engine.stats`` is a read/write facade over it (:class:`EngineStats`);
``reset_stats()`` zeroes the run scope while the lifetime scope keeps
accumulating.  Two opt-in hooks add the costly signals:

* ``tracer=`` (:class:`~repro_torch.obs.trace.Tracer`) records spans for
  the whole request lifecycle (submit, queued, prefix lookup, each
  prefill chunk, each decode step or speculative round, rollback,
  retire) on one track per request and an engine-loop track, exportable
  as Chrome trace-event JSON.  The tracer never synchronizes the device,
  and a run without an enabled tracer makes no tracing call.
* ``drift=`` (:class:`~repro_torch.obs.drift.DriftMonitor`) prices each
  executed step with the planner's simulator and histograms
  measured/simulated.  It adds one ``torch.cuda.synchronize()`` per
  prefill chunk so chunk ratios are wall time (decode steps and verify
  chunks already sync at sampling).

The TTFT and inter-token-latency histograms (``ttft_s``, ``itl_s``) fill
from the ``record_times`` stamps at retirement.  Neither hook perturbs
sampling: greedy tokens are bitwise equal with telemetry on or off.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import defaultdict, deque
from collections.abc import MutableMapping
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.execplan import COMPUTE_BACKENDS
from repro_torch.core.ring import ProcessRing, mesh_collectives_staged
from repro_torch.models.sharding import Rules, axis_rules, put_pairs, take_pages, take_pairs
from repro_torch.models.transformer import apply_model
from repro_torch.obs.drift import DriftMonitor
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import RequestTracks, Tracer
from repro_torch.serving.graphs import GraphedSteps, shape_of, wave_index, wave_rows
from repro_torch.serving.kvcache import cache_page_size, make_cache, map_cache_leaves, reset_cache
from repro_torch.serving.kvpool import PagedKVPool
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.sampler import SamplerConfig, sample, sample_positions
from repro_torch.serving.spec import SpeculativeDecoder, run_spec_round


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # perf_counter stamp per emitted token (record_times=True)
    token_times: List[float] = dataclasses.field(default_factory=list)
    # perf_counter stamp at submit() (record_times=True); TTFT per request
    # is token_times[0] - submit_time
    submit_time: Optional[float] = None


def _roundup(x: int, m: int) -> int:
    return -(-x // m) * m


def paged_capable(cfg: ModelConfig) -> bool:
    """Whether the zoo serves ``cfg`` through the paged protocol on one
    process: full-causal attention stacks only (recurrent and
    sliding-window caches are not position-addressable pages)."""
    kinds = tuple(cfg.block_pattern) + tuple(cfg.tail_pattern)
    return all(k == "attn" for k in kinds) and cfg.window == 0


class TransformerExecutor(GraphedSteps):
    """The model zoo (``models/transformer.py``) on one device, or under the
    HMP sharding rules on a mesh of ranks, behind the wave protocol and,
    for full-causal attention stacks, the paged one.

    params: the tree of ``models.params.init_params`` /
            ``params_from_numpy``; its device is the executor's.  Under
            ``rules`` with a mesh, the tree as ``DTensor``s
            (``init_params(rules=)``, ``place_params``).
    backend: "kernel" runs the flash-attention and RG-LRU scan kernels in
            prefill (their plain versions on CPU tensors; under a mesh on
            each rank's local shards); "eager" runs the plain versions on
            any device (the oracle).
    rules: ``models.sharding.Rules`` with a ``DeviceMesh`` over the ranks'
            process group (``make_rules(mesh, "prefill")``, as the
            reference's ``TransformerExecutor(params, cfg, rules)``): every
            call runs under ``axis_rules(rules)``, the caches are placed by
            the rules, the logits come back whole on every rank, and
            ``ring`` (a ``ProcessRing`` of the group) lets the engine agree
            on rank 0's sampled ids.  One table serves prefill and decode:
            the shape-aware spec leaves a one-token step's sequence whole.

    The paged pool is ``make_cache(cfg, num_pages, page_size)`` read as
    (page, in-page slot).  Each paged call gathers the slot's pages into a
    dense per-request view, runs ``apply_model`` on it, and scatters the
    new K/V back into the pages in place (the reference donates the pool
    to XLA for the same effect), so no call holds a second copy of the
    pool.  Under the rules the pool is placed by ``CACHE_AXES``: pages on
    the data axis (of size 1) and KV heads on the model axis, so each rank
    holds every page of its own KV heads (every KV head where they do not
    split).  The block tables are the same on every rank (the engine's
    host state moves on rank 0's ids), and the gather, the scatter and
    the per-slot cache write each touch the rank's own shard only
    (``sharding.take_pages``, ``take_pairs``, ``put_pairs``): no
    collective beyond the model's own.

    graphs: replay ``decode_paged`` (gather, the one-token model, scatter),
            ``prefill_paged`` (the prompt at its padded length, the logits
            row on the device, scatter), ``prefill_chunk`` (the whole row's
            gather, the chunk at its device-held offset, scatter) and the
            wave ``prefill`` and ``decode`` (rows and write positions on the
            device) as captured CUDA graphs, one a shape
            (``serving/graphs.py:StepGraph``, the reference's jitted paged
            decode, per-padded-length and per-chunk-shape prefill and
            per-wave-shape prefill and decode), with ``make_pool`` handing
            out the pool held for its geometry and user (the target's or
            a draft's), zeroed in place, and
            ``make_cache`` the wave cache held for its batch size, reset in
            place; the same steps run eagerly without it.  Settable;
            setting it starts new graphs and ``graph_stats`` and lets the
            held pool and caches go.
            Raises ``ValueError`` off the card and under ``rules``
            (``DTensor`` dispatches on the host and the mesh's collectives
            stage through it: neither can be captured).
    """

    def __init__(self, params, cfg: ModelConfig, *, backend: str = "kernel",
                 rules: Optional[Rules] = None, graphs: bool = False):
        if backend not in COMPUTE_BACKENDS:
            raise ValueError(f"unknown compute backend {backend!r}; "
                             f"one of {COMPUTE_BACKENDS}")
        self.params = params
        self.cfg = cfg
        self.backend = backend
        self.device = params["embed"]["tok"].device
        self.rules = rules
        self.mesh = None if rules is None else rules.mesh
        self.ring = None
        if self.mesh is not None:
            import torch.distributed as dist

            if self.mesh.size() != dist.get_world_size():
                raise ValueError(f"the mesh has {self.mesh.size()} ranks, the process group "
                                 f"{dist.get_world_size()}: the executor's mesh spans the group")
            if (self.mesh.device_type == "cuda" and dist.get_backend() == "gloo"
                    and not mesh_collectives_staged()):
                raise RuntimeError("gloo takes no CUDA all-gather: join the group with "
                                   "launch.ranks.init, which stages the mesh's collectives "
                                   "through host memory")
            self.ring = ProcessRing(dist.get_rank(), dist.get_world_size())
        self.graphs = graphs

    def _graphs_refused(self) -> Optional[str]:
        if self.rules is not None:
            return ("graphs=True runs one process without sharding rules: DTensor "
                    "dispatch and the mesh's host-staged collectives cannot be captured")
        return None

    @property
    def prompt_pad_multiple(self) -> int:
        """Prompts need no length padding on one device."""
        return 1

    @property
    def supports_paged(self) -> bool:
        """Paged serving covers full-causal attention stacks; recurrent and
        sliding-window caches are not position-addressable pages; under a
        mesh as on one device."""
        return paged_capable(self.cfg)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device).long()

    def _model(self, **kw):
        """``apply_model`` on this executor's params and backend; under a
        mesh inside ``axis_rules(rules)``, with plain tensors entering the
        ``DTensor`` ops replicated, and the logits gathered whole."""
        if self.mesh is None:
            return apply_model(self.params, self.cfg, backend=self.backend, **kw)
        from torch.distributed.tensor.experimental import implicit_replication

        with axis_rules(self.rules), implicit_replication():
            logits, cache = apply_model(self.params, self.cfg, backend=self.backend, **kw)
            return logits.full_tensor(), cache

    # --- wave protocol -------------------------------------------------------
    def make_cache(self, batch: int, max_len: int):
        """The wave cache; with graphs on, the one held for ``batch``, reset
        in place (bitwise a fresh one): the caller's earlier wave's cache
        is this one."""
        return self._wave_cache(batch, max_len, lambda: make_cache(
            self.cfg, batch, max_len, device=self.device, rules=self.rules), reset_cache)

    def prefill(self, tokens, cache, lengths=None):
        """Prefill a batch of prompts into ``cache``.  Returns the logits of
        each row's last real prompt token, (B, V), and the cache.
        ``lengths`` (B,) names each row's real length when prompts were
        right-padded to a shared length; None takes the last column.  On
        one process the step (:meth:`_wave_prefill_step`, the rows on the
        device) runs eagerly or through its graph; under the rules the
        last column stays a host int."""
        if self.mesh is None:
            return self._step("wave_prefill", self._wave_prefill_step, cache, tokens,
                              wave_rows(tokens, lengths)), cache
        tokens = self._tensor(tokens)
        rows = tokens.shape[1] - 1 if lengths is None else self._tensor(lengths) - 1
        return self._model(tokens=tokens, mode="prefill", cache=cache, rows=rows)

    def _wave_prefill_step(self, cache, tokens, rows) -> torch.Tensor:
        """The step that ``prefill`` runs or captures on one process:
        tokens (B, S) and the row of each one's logits, (B,), on the
        device."""
        logits, _ = self._model(tokens=tokens, mode="prefill", cache=cache, rows=rows)
        return logits

    def decode(self, tokens, cache, index):
        """One decode step of the batch: tokens (B, 1); index a host int
        (lockstep) or (B,) per-row write positions.  Returns (logits (B,
        V), cache).  On one process the lockstep index is broadcast to
        every row here and the step (:meth:`_wave_decode_step`) runs
        eagerly or through its graph; under the rules it stays a host
        int."""
        if self.mesh is None:
            return self._step("wave_decode", self._wave_decode_step, cache, tokens,
                              wave_index(tokens, index)), cache
        if not isinstance(index, int):
            index = self._tensor(index)
        logits, cache = self._model(tokens=self._tensor(tokens), mode="decode", cache=cache,
                                    cache_index=index)
        return logits[:, -1], cache

    def _wave_decode_step(self, cache, tokens, index) -> torch.Tensor:
        """The step that ``decode`` runs or captures on one process: tokens
        (B, 1) and each row's write position, (B,), on the device."""
        logits, _ = self._model(tokens=tokens, mode="decode", cache=cache, cache_index=index)
        return logits[:, -1]

    # --- paged protocol ------------------------------------------------------
    def make_pool(self, num_pages: int, page_size: int, *, user: str = "target"):
        """Pool storage: the cache tree with (batch, seq) read as (page,
        in-page slot); every leaf is (G?, P, page_size, kv, hd).  With
        graphs on, the pool held for ``user`` (the engine's ``"target"``
        or a speculative ``"draft"``) at this geometry, zeroed in place
        (bitwise a fresh one), so the graphs bound to it outlive the
        engine run."""
        return self._paged_pool(num_pages, page_size, lambda: make_cache(
            self.cfg, num_pages, page_size, device=self.device, rules=self.rules), reset_cache,
            user)

    @staticmethod
    def gather_pages(pool, block_table):
        """Dense (B, W * page, kv, hd) views of the pages of each row of
        ``block_table`` (B, W): a copy, one per call, of those pages only;
        under a mesh each rank's copy of its own shard of the pages."""
        return map_cache_leaves(
            pool, pool, lambda leaf, _, grouped: take_pages(leaf, int(grouped), block_table))

    @staticmethod
    def _scatter(pool, dense, phys, within, rows, pos) -> None:
        """pool[page phys[i], slot within[i]] = dense[rows[i], pos[i]], in
        place, for every leaf; under a mesh on each rank's shards."""

        def scatter(leaf, new, grouped):
            put_pairs(leaf, int(grouped), phys, within, take_pairs(new, int(grouped), rows, pos))

        map_cache_leaves(pool, dense, scatter)

    def prefill_paged(self, tokens, pool, block_row, length: int):
        """Prefill one request (batch 1) and scatter its K/V into its pages.

        tokens: (1, S_pad); length: real prompt length (logits are taken at
        ``length - 1``); block_row: (W,) physical pages of this request.
        Returns ``(logits (1, V), pool)``.  On one process the step
        (:meth:`_prefill_paged_step`, the row on the device) runs eagerly
        or through its graph; under the rules the row stays a host int.
        """
        b, s = shape_of(tokens)
        if b != 1:
            raise ValueError("paged prefill is per-request: batch must be 1")
        length = int(length)
        if not 0 < length <= s:
            raise ValueError(f"length {length} outside the {s} prompt positions")
        if self.mesh is None:
            return self._step("prefill", self._prefill_paged_step, pool, tokens, block_row,
                              np.array([length - 1])), pool
        return self._prefill_paged_step(pool, self._tensor(tokens), self._tensor(block_row),
                                        length - 1), pool

    def _prefill_paged_step(self, pool, tokens, block_row, row) -> torch.Tensor:
        """The step that ``prefill_paged`` runs or captures on one process:
        tokens (1, S), block_row (W,) and the row of the logits, (1,), all
        on the device; no value is read on the host, so one program serves
        every length that pads to S (the reference's traced ``length``).
        The dense (1, S) cache lives only inside the step (from the graph's
        pool under a capture).  Under the rules ``row`` is a host int."""
        s = tokens.shape[1]
        dense = make_cache(self.cfg, 1, s, device=self.device, rules=self.rules)
        logits, dense = self._model(tokens=tokens, mode="prefill", cache=dense, rows=row)
        ps = cache_page_size(pool)
        pos = torch.arange(s, device=self.device)
        self._scatter(pool, dense, block_row[pos // ps], pos % ps, torch.zeros_like(pos), pos)
        return logits

    def prefill_chunk(self, tokens, pool, block_row, *, offset: int, length: int):
        """One chunked-prefill step (batch 1): gather the slot's pages into
        a dense view, run the chunk at absolute positions ``[offset, offset
        + S)`` attending back to every written position (earlier chunks and
        shared prefix pages), and scatter the chunk's K/V into its pages.
        Returns ``(logits, pool)``, logits of *every* chunk row, (1, S, V):
        row ``j`` predicts position ``offset + j + 1``.

        The bounds are checked here, on the host.  On one process the step
        (:meth:`_chunk_step`) gathers the whole block row, as the reference
        does, and takes the offset on the device, eagerly or through its
        graph.  Under the rules the offset stays a host int and only the
        pages up to the chunk's end are gathered (the attention reads no
        key past ``offset + S``, so the numbers are the same).
        """
        b, s = shape_of(tokens)
        if b != 1:
            raise ValueError("paged prefill is per-request: batch must be 1")
        offset, w, ps = int(offset), shape_of(block_row)[0], cache_page_size(pool)
        if offset < 0 or offset + s > w * ps:
            raise ValueError(f"positions [{offset}, {offset + s}) exceed the block row "
                             f"({w} pages x {ps})")
        if self.mesh is None:
            return self._step("chunk", self._chunk_step, pool, tokens, block_row,
                              offset), pool
        row = self._tensor(block_row)
        dense = self.gather_pages(pool, row[: -(-(offset + s) // ps)][None])
        logits, dense = self._model(tokens=self._tensor(tokens), mode="prefill", cache=dense,
                                    cache_index=offset)
        pos = offset + torch.arange(s, device=self.device)
        self._scatter(pool, dense, row[pos // ps], pos % ps, torch.zeros_like(pos), pos)
        return logits, pool

    def _chunk_step(self, pool, tokens, block_row, offset) -> torch.Tensor:
        """The step that ``prefill_chunk`` runs or captures on one process:
        tokens (1, S), block_row (W,) and the 0-dim offset, all on the
        device; no value is read on the host, so one program serves every
        offset (the reference's traced scalar)."""
        s = tokens.shape[1]
        dense = self.gather_pages(pool, block_row[None])
        logits, dense = self._model(tokens=tokens, mode="prefill", cache=dense,
                                    cache_index=offset)
        ps = cache_page_size(pool)
        pos = offset + torch.arange(s, device=self.device)
        self._scatter(pool, dense, block_row[pos // ps], pos % ps, torch.zeros_like(pos), pos)
        return logits

    def decode_paged(self, tokens, pool, block_table, positions):
        """One continuous-batching step: gather each slot's pages into a
        dense per-slot view, run the single-token model at per-slot depths,
        scatter each new K/V entry back into its page.  Rows of idle slots
        carry the null page and position 0.  Returns ``(logits (B, V),
        pool)``; the pool is updated in place."""
        return self._step("decode", self._decode_step, pool, tokens, positions,
                          block_table), pool

    def _decode_step(self, pool, tokens, positions, bt) -> torch.Tensor:
        """The step that ``decode_paged`` runs or captures, on device
        tensors; no value is read on the host."""
        dense = self.gather_pages(pool, bt)
        logits, dense = self._model(tokens=tokens, mode="decode", cache=dense,
                                    cache_index=positions)
        ps = cache_page_size(pool)
        rows = torch.arange(bt.shape[0], device=self.device)
        self._scatter(pool, dense, bt[rows, positions // ps], positions % ps,
                      rows, positions)
        return logits[:, -1]


@dataclasses.dataclass
class _Slot:
    """Per-slot decode state."""
    req: Request
    last_token: int
    next_index: int   # absolute position the next decode step writes
    limit: int        # min(max_new_tokens, max_len - prompt_len)


@dataclasses.dataclass
class _PrefillTask:
    """An admitted request whose prompt is (still) being prefilled.

    The pool pages are already reserved (and prefix-hit pages attached);
    ``next_off`` is the first absolute position not yet written: it starts
    at the cached prefix length and advances one chunk per step."""
    req: Request
    slot: int
    tokens: np.ndarray  # (1, s_pad) bucket-padded prompt
    s: int              # real prompt length
    s_pad: int
    limit: int
    next_off: int


class EngineStats(MutableMapping):
    """The engine's stats as a mapping, a facade over its registry.

    Counters read and write straight through to the
    :class:`~repro_torch.obs.metrics.MetricsRegistry`
    (``stats["prefill_tokens"] += n``), and so does the
    ``peak_shared_pages`` gauge.  ``prefill_oneshots`` (prefills that ran
    as one ``prefill_paged`` call, beside ``prefill_chunks``) and
    ``prefill_waves`` (wave prefills) are the port's own counters.  A
    speculative round counts one ``decode_steps`` per verified slot, as in
    the reference.

    Derived keys are computed on read and refuse assignment:
    ``spec_acceptance`` from the accepted/proposed counters,
    ``spec_accept_counts`` (accepted drafts per round -> rounds) as the
    value-count view of the ``spec_accepted_per_round`` histogram.
    """

    _COUNTERS = ("requests", "prefill_tokens", "decode_steps", "decode_tokens",
                 "prefill_chunks", "prefill_oneshots", "prefill_waves", "prefix_hits",
                 "cached_prefix_tokens", "spec_steps", "spec_proposed", "spec_accepted")
    _KEYS = _COUNTERS + ("peak_shared_pages", "spec_acceptance", "spec_accept_counts")

    def __init__(self, metrics: MetricsRegistry):
        self._m = metrics
        for k in self._COUNTERS:
            metrics.counter(k)
        metrics.gauge("peak_shared_pages")
        metrics.histogram("spec_accepted_per_round",
                          "draft tokens accepted per speculative round")

    def __getitem__(self, key):
        if key in self._COUNTERS:
            return self._m.counter(key).value
        if key == "peak_shared_pages":
            return int(self._m.gauge(key).value)
        if key == "spec_acceptance":
            proposed = self._m.counter("spec_proposed").value
            return (self._m.counter("spec_accepted").value / proposed
                    if proposed else 0.0)
        if key == "spec_accept_counts":
            return {int(v): n for v, n in sorted(
                self._m.histogram("spec_accepted_per_round").value_counts().items())}
        raise KeyError(key)

    def __setitem__(self, key, value):
        if key in self._COUNTERS:
            self._m.counter(key).set_run(value)
        elif key == "peak_shared_pages":
            self._m.gauge(key).set(int(value))
        else:
            raise TypeError(f"stats[{key!r}] is derived from the metrics registry "
                            f"and cannot be assigned")

    def __delitem__(self, key):
        raise TypeError("engine stats keys are fixed")

    def __iter__(self):
        return iter(self._KEYS)

    def __len__(self):
        return len(self._KEYS)

    def __repr__(self):
        return repr(dict(self))

    def __eq__(self, other):
        if isinstance(other, (dict, MutableMapping)):
            return dict(self) == dict(other)
        return NotImplemented


class ServingEngine:
    """Serving engine over an executor.  ``stats`` (:class:`EngineStats`)
    counts requests, computed prompt tokens (the uncached suffix under
    prefix hits), decode steps and tokens, prefill calls, prefix-cache hits
    and speculative rounds of the engine's runs since the last
    ``reset_stats()``; ``metrics`` is the registry behind it, with the
    gauges and histograms; ``prefix_stats`` holds the prefix tree's own
    stats after a run with ``prefix_cache=True``."""

    def __init__(self, executor, *, max_batch: int = 8, max_len: int = 512,
                 sampler: SamplerConfig = SamplerConfig(), rng_seed: int = 0,
                 scheduler: str = "auto", page_size: int = 16,
                 num_pages: Optional[int] = None, record_times: bool = False,
                 prefix_cache: bool = False, prefill_chunk: Optional[int] = None,
                 draft_executor=None, spec_k: Optional[int] = None,
                 draft_device: Optional[int] = None,
                 tracer: Optional[Tracer] = None, drift: Optional[DriftMonitor] = None,
                 metrics: Optional[MetricsRegistry] = None):
        if scheduler not in ("auto", "continuous", "wave"):
            raise ValueError(f"unknown scheduler {scheduler!r}")
        if scheduler == "continuous" and not getattr(executor, "supports_paged", False):
            raise ValueError("the continuous scheduler needs the paged executor protocol")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1 token")
        if (prefix_cache or prefill_chunk) and not hasattr(executor, "prefill_chunk"):
            raise ValueError("prefix caching / chunked prefill need an executor with "
                             "the prefill_chunk protocol")
        # a Galaxy executor on a ProcessRing runs this engine on every rank:
        # the ranks agree on each sampled id (``_sample``), so admission,
        # the prefix cache and the pool move in step on all of them
        self._ring = getattr(executor, "ring", None)
        split = self._ring is not None and len(self._ring.devices) < self._ring.num_devices
        if spec_k is not None and split:
            # the draft lives on one rank, the one holding cluster device
            # ``draft_device``: only there is there a draft executor
            if draft_device is None or not 0 <= draft_device < self._ring.num_devices:
                raise ValueError(
                    f"speculative decoding on a ring of {self._ring.num_devices} processes "
                    f"needs the draft's device index (draft_device), got {draft_device}")
            if (draft_executor is not None) != (draft_device in self._ring.devices):
                raise ValueError(
                    f"the draft executor belongs to the rank of device {draft_device} "
                    f"alone; this process holds devices {self._ring.devices}")
        elif (draft_executor is None) != (spec_k is None):
            raise ValueError("speculative decoding needs both draft_executor and spec_k")
        if spec_k is not None:
            if spec_k < 1:
                raise ValueError("spec_k must be >= 1")
            if scheduler == "wave":
                raise ValueError(
                    "speculative decoding requires the continuous scheduler "
                    "(the wave path has no paged pool to verify against)")
            if sampler.temperature != 0.0:
                raise ValueError(
                    "speculative decoding is greedy-only: the verify chunk's "
                    "per-row argmax is the sequential token only at temperature=0")
            if not hasattr(executor, "prefill_chunk"):
                raise ValueError("speculative verification needs the target "
                                 "executor's prefill_chunk protocol")
            if draft_executor is not None and not getattr(draft_executor, "supports_paged",
                                                          False):
                raise ValueError("draft executor must implement the paged protocol")
        # the proposals go from the draft's rank to every rank each round
        self.draft_ring = self._ring if spec_k is not None and split else None
        self.executor = executor
        self.scheduler = scheduler
        self.max_batch = max_batch
        self.max_len = max_len
        self.sampler = sampler
        self.generator = torch.Generator(
            device=getattr(executor, "device", "cpu")).manual_seed(rng_seed)
        self.page_size = page_size
        self.num_pages = num_pages
        self.record_times = record_times
        self.prefix_cache = prefix_cache
        self.prefill_chunk = prefill_chunk
        self.draft_executor = draft_executor
        self.spec_k = spec_k
        self.draft_device = draft_device
        self.queue: deque = deque()
        # the registry is always live (it is the stats' storage); span
        # tracing and drift pricing are the opt-in hooks
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.stats = EngineStats(self.metrics)
        self.tracer = tracer
        self._trace = tracer if (tracer is not None and tracer.enabled) else None
        self._tracks = RequestTracks(self._trace) if self._trace is not None else None
        self.drift = drift
        if drift is not None and drift.registry is None:
            drift.registry = self.metrics
        self.pool: Optional[PagedKVPool] = None
        self.spec: Optional[SpeculativeDecoder] = None
        self.prefix_stats: Optional[Dict] = None

    def reset_stats(self) -> None:
        """Zero the run scope of the stats (counters, gauges, histograms);
        the lifetime scope (``metrics.snapshot("lifetime")``) keeps
        accumulating across resets."""
        self.metrics.reset_run()
        self.prefix_stats = None

    def submit(self, req: Request) -> None:
        if self.record_times:
            req.submit_time = time.perf_counter()
        self.queue.append(req)
        self.stats["requests"] += 1
        if self._tracks is not None:
            self._tracks.submit(req.uid)
        self.metrics.gauge("queue_depth").set(len(self.queue))

    def _sample(self, logits) -> np.ndarray:
        """Token ids of ``logits``: on a ring of processes, rank 0's
        (``ring.agree``), so every rank's host state moves on from the same
        ids."""
        ids = sample(logits, self.generator, self.sampler).cpu()
        if self._ring is not None:
            ids = self._ring.agree(ids)
        return ids.numpy()

    def _sample_positions(self, logits) -> np.ndarray:
        """Per-position sampling of the speculative verify chunk, (B, K, V)
        -> (B, K), agreed as ``_sample`` agrees; greedy, the only mode
        speculation runs in, draws nothing from the generator."""
        ids = sample_positions(logits, self.generator, self.sampler).cpu()
        if self._ring is not None:
            ids = self._ring.agree(ids)
        return ids.numpy()

    def _emit(self, r: Request, token: int, limit: int) -> bool:
        """Append one token; returns True if the request just finished.
        No telemetry call lives here: the TTFT/ITL histograms fill from the
        ``token_times`` stamps at retirement (:meth:`_retire_obs`)."""
        r.output.append(token)
        if self.record_times:
            r.token_times.append(time.perf_counter())
        if (r.eos_id is not None and token == r.eos_id) or len(r.output) >= limit:
            r.done = True
            return True
        return False

    def _retire_obs(self, r: Request, **span_args) -> None:
        """At a request's completion: close its span track and fill the
        latency histograms from its ``record_times`` stamps (TTFT = first
        token - submit; ITL = consecutive gaps)."""
        if self._tracks is not None and self._tracks.is_open(r.uid):
            self._tracks.finish(r.uid, tokens=len(r.output), **span_args)
        if r.submit_time is not None and r.token_times:
            self.metrics.histogram("ttft_s", "time to first token (s)").observe(
                r.token_times[0] - r.submit_time)
            itl = self.metrics.histogram("itl_s", "inter-token latency (s)")
            ts = r.token_times
            for a, b in zip(ts, ts[1:]):
                itl.observe(b - a)

    def _pool_gauges(self, pool: PagedKVPool) -> None:
        """KV-pool gauges, updated at admission and retirement boundaries."""
        m = self.metrics
        used = pool.used_pages
        m.gauge("kv_pages_used").set(used)
        m.gauge("kv_pool_occupancy", "used / usable pool pages").set(pool.occupancy())
        m.gauge("kv_pages_peak", "peak pages used").set_max(used)
        m.gauge("kv_shared_pages").set(pool.shared_page_count())

    def run(self) -> List[Request]:
        """Drain the queue; returns all completed requests."""
        mode = self.scheduler
        if mode == "auto":
            mode = ("continuous"
                    if getattr(self.executor, "supports_paged", False) else "wave")
        if mode == "continuous":
            return self._run_continuous()
        if self.spec_k is not None:
            raise ValueError("speculative decoding requires the continuous scheduler, "
                             "but this executor only supports the wave path")
        if self.prefix_cache or self.prefill_chunk:
            raise ValueError("prefix caching / chunked prefill belong to the continuous "
                             "scheduler (the wave path has no paged pool to share)")
        return self._run_waves()

    def _run_continuous(self) -> List[Request]:
        ex = self.executor
        ps = self.page_size
        n_slots = self.max_batch
        # the same grain aligns prefix-cache hits and prefill chunks, so
        # every suffix chunk starts on a page boundary
        grain = math.lcm(getattr(ex, "prompt_pad_multiple", 1), ps)
        pages_per_slot = _roundup(self.max_len, grain) // ps
        total_pages = self.num_pages or (1 + n_slots * pages_per_slot)
        pool = PagedKVPool(total_pages, ps, n_slots, pages_per_slot)
        storage = ex.make_pool(total_pages, ps)
        pcache = PrefixCache(pool, grain=grain) if self.prefix_cache else None
        self.pool = pool  # introspection (tests / benches)
        # telemetry locals: `tr is None` short-circuits every tracing call
        # site below, so a run without a tracer makes no tracing call
        tr = self._trace
        tracks = self._tracks
        drift = self.drift
        wire_stats = getattr(ex, "wire_stats", None)
        if wire_stats is not None:
            for name, value in wire_stats().items():
                self.metrics.gauge(name).set(value)
        self._pool_gauges(pool)
        spec = None
        if self.draft_executor is not None:
            # the draft pool mirrors the target pool's geometry, so slot
            # indices and position arithmetic are shared between the two
            spec = SpeculativeDecoder(self.draft_executor, self.spec_k, num_slots=n_slots,
                                      page_size=ps, pages_per_slot=pages_per_slot)
            self.spec = spec  # introspection (tests / benches)
        chunk_tokens = (None if self.prefill_chunk is None
                        else _roundup(self.prefill_chunk, grain))
        slots: List[Optional[_Slot]] = [None] * n_slots
        prefills: deque = deque()  # admitted slots still mid-prefill
        finished: List[Request] = []

        def prefill_step(t: _PrefillTask) -> bool:
            """Advance one chunk; True when the prompt is fully prefilled.

            The final chunk always covers position ``s - 1`` (chunk starts
            are grain-aligned and ``s_pad - s < grain``), so its logits row
            is the last real prompt token's: the first sampled token."""
            nonlocal storage
            off = t.next_off
            size = (t.s_pad - off if chunk_tokens is None
                    else min(chunk_tokens, t.s_pad - off))
            block_row = pool.block_table[t.slot].copy()
            chunk = t.tokens[:, off:off + size]
            if tr is not None:
                tr.begin("engine", "prefill_chunk", uid=t.req.uid, offset=off, rows=size)
            t0 = time.perf_counter() if drift is not None else 0.0
            if off == 0 and size == t.s_pad:
                # one-shot (no context gather): the path without chunking
                logits, storage = ex.prefill_paged(chunk, storage, block_row, length=t.s)
                self.stats["prefill_oneshots"] += 1
            else:
                logits, storage = ex.prefill_chunk(chunk, storage, block_row,
                                                   offset=off, length=t.s)
                # chunk logits carry every row; the first token comes from
                # the last *real* prompt token's row
                logits = logits[:, max(0, min(t.s - 1 - off, size - 1))]
                self.stats["prefill_chunks"] += 1
            if drift is not None:
                # a prefill has no sync point of its own: pricing its wall
                # time costs one synchronize here (the tracer alone never
                # syncs)
                if logits.is_cuda:
                    torch.cuda.synchronize(logits.device)
                drift.observe("prefill_chunk", time.perf_counter() - t0,
                              rows=size, context=off + size)
            if tr is not None:
                tr.end("engine")
            # computed prompt tokens: the suffix only under prefix hits
            self.stats["prefill_tokens"] += max(0, min(t.s, off + size) - off)
            t.next_off = off + size
            if t.next_off < t.s_pad:
                return False
            if pcache is not None:
                # publish this prompt's full pages for later admissions
                # (the partial tail page stays slot-private)
                pcache.insert(t.req.prompt, pool.block_table[t.slot])
            tok = int(self._sample(logits)[0])
            if self._emit(t.req, tok, t.limit):
                pool.retire(t.slot)
                finished.append(t.req)
                self._retire_obs(t.req)
                self._pool_gauges(pool)
            else:
                slots[t.slot] = _Slot(t.req, tok, t.s, t.limit)
                if tracks is not None:
                    tracks.phase(t.req.uid, "decode")
                if spec is not None:
                    spec.admit(t.slot, t.tokens, t.s,
                               max_positions=max(t.s_pad, t.s + t.limit))
            return True

        def admit() -> None:
            """Admission: prefix lookup -> shared-page refcount bump ->
            suffix-only prefill (inline, or queued as chunk tasks)."""
            while self.queue:
                slot = pool.free_slot()
                if slot is None:
                    return
                r = self.queue[0]
                s = len(r.prompt)
                limit = min(r.max_new_tokens, self.max_len - s)
                if limit <= 0:  # no room to decode even one token
                    self.queue.popleft()
                    r.done = True
                    finished.append(r)
                    self._retire_obs(r, rejected=True)
                    self.metrics.gauge("queue_depth").set(len(self.queue))
                    continue
                s_pad = _roundup(s, grain)
                max_positions = max(s_pad, s + limit)
                shared: List[int] = []
                cached = 0
                if pcache is not None:
                    if tr is not None:
                        tr.begin("engine", "prefix_lookup", uid=r.uid)
                    shared, cached = pcache.lookup(r.prompt)
                    if tr is not None:
                        tr.end("engine", cached_tokens=cached, shared_pages=len(shared))
                if not pool.can_admit(max_positions, shared=len(shared)):
                    if pcache is not None:
                        need = (pool.pages_for(max_positions) - len(shared)
                                - pool.available)
                        pcache.evict(need)
                        # eviction may have pruned our own match: re-walk
                        shared, cached = pcache.lookup(r.prompt)
                    if not pool.can_admit(max_positions, shared=len(shared)):
                        return
                self.queue.popleft()
                pool.admit(slot, initial_positions=s_pad,
                           max_positions=max_positions, shared_pages=shared)
                self.metrics.gauge("queue_depth").set(len(self.queue))
                if tracks is not None:
                    tracks.phase(r.uid, "prefill", slot=slot, cached_tokens=cached)
                self._pool_gauges(pool)
                if shared:
                    self.stats["prefix_hits"] += 1
                    self.stats["cached_prefix_tokens"] += cached
                    self.stats["peak_shared_pages"] = max(
                        self.stats["peak_shared_pages"], pool.shared_page_count())
                    pool.check()
                tokens = np.zeros((1, s_pad), np.int64)
                tokens[0, :s] = r.prompt
                task = _PrefillTask(r, slot, tokens, s, s_pad, limit, next_off=cached)
                if chunk_tokens is None:
                    # no interleaving requested: prefill to completion now
                    while not prefill_step(task):
                        pass
                else:
                    prefills.append(task)

        admit()
        while any(slots) or prefills or self.queue:
            if not any(slots) and not prefills:
                # nothing active and nothing admissible: drop the whole
                # prefix tree (its pins may be what starves the head
                # request) and retry before declaring the pool too small
                if pcache is not None and len(pcache):
                    pcache.evict(total_pages)
                    admit()
                    if any(slots) or prefills:
                        continue
                r = self.queue[0]
                raise RuntimeError(
                    f"request uid={r.uid} (prompt {len(r.prompt)}, "
                    f"max_new {r.max_new_tokens}) cannot fit the pool of "
                    f"{total_pages} pages x {ps}"
                )
            if prefills:
                # one chunk per iteration, interleaved with the decode step
                # below: long prompts do not stall live decode slots
                if prefill_step(prefills[0]):
                    prefills.popleft()
            live = [i for i, sl in enumerate(slots) if sl is not None]
            if live and self.spec_k is not None:
                # speculative round: the draft proposes (batched), the
                # target verifies each slot's proposals in one chunk, and
                # rejections roll back by block-table truncation; on a
                # ring of processes every rank runs it, the draft's rank
                # with the draft (``spec``) and the others without
                storage, done = run_spec_round(self, spec, slots, live, pool, storage)
                for i, req in done:
                    slots[i] = None
                    finished.append(req)
                    self._retire_obs(req)
                if done:
                    self._pool_gauges(pool)
            elif live:
                tokens = np.zeros((n_slots, 1), np.int64)
                positions = np.zeros(n_slots, np.int64)
                live_mask = np.zeros(n_slots, bool)
                for i in live:
                    pool.ensure(i, slots[i].next_index)
                    tokens[i, 0] = slots[i].last_token
                    positions[i] = slots[i].next_index
                    live_mask[i] = True
                # non-live rows (idle or mid-prefill) decode against the
                # null page: their dummy write must not touch real pages
                bt = np.where(live_mask[:, None], pool.block_table, 0)
                if tr is not None:
                    tr.begin("engine", "decode_step", live=len(live))
                t0 = time.perf_counter() if drift is not None else 0.0
                logits, storage = ex.decode_paged(tokens, storage, bt, positions)
                self.stats["decode_steps"] += 1
                self.stats["decode_tokens"] += len(live)
                toks = self._sample(logits)
                if drift is not None:
                    # sampling copied the tokens to the host, which synced
                    # the step: the measured time is wall time
                    drift.observe("decode", time.perf_counter() - t0, rows=1,
                                  context=int(positions[live].max()) + 1)
                if tr is not None:
                    tr.end("engine")
                retired = False
                for i in live:
                    sl = slots[i]
                    if self._emit(sl.req, int(toks[i]), sl.limit):
                        pool.retire(i)
                        slots[i] = None
                        finished.append(sl.req)
                        self._retire_obs(sl.req)
                        retired = True
                    else:
                        sl.last_token = int(toks[i])
                        sl.next_index += 1
                if retired:
                    self._pool_gauges(pool)
            admit()  # freed slots refill immediately — continuous batching
        if pcache is not None:
            pool.check()  # the refcount algebra at the end of the run
            self.prefix_stats = pcache.stats()
            pcache.publish(self.metrics)
        else:
            self.prefix_stats = None
        return finished

    # --- wave execution ------------------------------------------------------
    def _bucket_len(self, prompt_len: int) -> int:
        """Wave bucket key: prompt length rounded up to the executor's
        padding multiple (exact lengths for a one-device executor)."""
        return _roundup(prompt_len, getattr(self.executor, "prompt_pad_multiple", 1))

    def _next_wave(self) -> List[Request]:
        """Take up to max_batch queued requests from the largest bucket."""
        if not self.queue:
            return []
        buckets: Dict[int, List[Request]] = defaultdict(list)
        for r in self.queue:
            buckets[self._bucket_len(len(r.prompt))].append(r)
        _, reqs = max(buckets.items(), key=lambda kv: len(kv[1]))
        wave = reqs[: self.max_batch]
        taken = {id(r) for r in wave}
        self.queue = deque(r for r in self.queue if id(r) not in taken)
        return wave

    def _run_waves(self) -> List[Request]:
        finished: List[Request] = []
        while self.queue:
            wave = self._next_wave()
            if not wave:
                break
            self.metrics.gauge("queue_depth").set(len(self.queue))
            finished.extend(self._run_wave(wave))
        return finished

    def _run_wave(self, wave: List[Request]) -> List[Request]:
        tr = self._trace
        tracks = self._tracks
        # zero-budget requests (max_new_tokens=0, prompt filling or exceeding
        # max_len) never emit and never prefill: the cache only holds
        # max_len positions
        for r in wave:
            if min(r.max_new_tokens, self.max_len - len(r.prompt)) <= 0:
                r.done = True
                self._retire_obs(r, rejected=True)
        live = [r for r in wave if not r.done]
        if not live:
            return wave
        ex = self.executor
        b = len(live)
        lengths = np.array([len(r.prompt) for r in live], np.int64)
        limits = np.minimum([r.max_new_tokens for r in live], self.max_len - lengths)
        budget = int(limits.max())
        uniform = int(lengths.min()) == int(lengths.max())
        s_pad = int(lengths[0]) if uniform else self._bucket_len(int(lengths.max()))

        tokens = np.zeros((b, s_pad), np.int64)
        for i, r in enumerate(live):
            tokens[i, : lengths[i]] = r.prompt
        cache = ex.make_cache(b, self.max_len)
        if tracks is not None:
            for r in live:
                tracks.phase(r.uid, "prefill", wave=True)
        if tr is not None:
            tr.begin("engine", "wave_prefill", batch=b, s_pad=s_pad)
        if uniform:
            logits, cache = ex.prefill(tokens, cache)
        else:
            logits, cache = ex.prefill(tokens, cache, lengths=lengths)
        if tr is not None:
            tr.end("engine")
        self.stats["prefill_tokens"] += int(lengths.sum())
        self.stats["prefill_waves"] += 1
        if tracks is not None:
            # the wave decodes in lockstep: its requests' decode phases open
            # together once the joint prefill is dispatched
            for r in live:
                tracks.phase(r.uid, "decode")

        active = np.ones(b, bool)
        for step in range(budget):
            next_tok = self._sample(logits)
            for i, r in enumerate(live):
                if active[i] and self._emit(r, int(next_tok[i]), int(limits[i])):
                    active[i] = False
                    self._retire_obs(r)
            if not active.any():
                break
            if uniform:
                index = int(lengths[0]) + step
            else:
                # clamp retired rows that out-ran their own length budget;
                # their writes land in a dead cache row and are never read
                index = np.minimum(lengths + step, self.max_len - 1)
            if tr is not None:
                tr.begin("engine", "decode_step", live=int(active.sum()))
            logits, cache = ex.decode(next_tok[:, None], cache, index)
            if tr is not None:
                tr.end("engine")
            self.stats["decode_steps"] += 1
            self.stats["decode_tokens"] += int(active.sum())
        for i, r in enumerate(live):
            r.done = True
            if active[i]:  # budget exhausted before _emit finished it
                self._retire_obs(r)
        return wave
