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
  (``make_cache`` / ``prefill`` / ``decode``), which every executor has;
  the model zoo's :class:`TransformerExecutor` has only this one, since
  recurrent and sliding-window caches are not position-addressable pages.

``scheduler="auto"`` takes the continuous scheduler when the executor
supports the paged protocol, else waves.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.execplan import COMPUTE_BACKENDS
from repro_torch.models.transformer import apply_model
from repro_torch.serving.kvcache import make_cache
from repro_torch.serving.kvpool import PagedKVPool
from repro_torch.serving.sampler import SamplerConfig, sample


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


class TransformerExecutor:
    """The model zoo (``models/transformer.py``) on one device, behind the
    wave protocol.

    params: the tree of ``models.params.init_params`` /
            ``params_from_numpy``; its device is the executor's.
    backend: "kernel" runs the flash-attention and RG-LRU scan kernels in
            prefill (their plain versions on CPU tensors); "eager" runs the
            plain versions on any device (the oracle).
    """

    def __init__(self, params, cfg: ModelConfig, *, backend: str = "kernel"):
        if backend not in COMPUTE_BACKENDS:
            raise ValueError(f"unknown compute backend {backend!r}; "
                             f"one of {COMPUTE_BACKENDS}")
        self.params = params
        self.cfg = cfg
        self.backend = backend
        self.device = params["embed"]["tok"].device

    @property
    def prompt_pad_multiple(self) -> int:
        """Prompts need no length padding on one device."""
        return 1

    @property
    def supports_paged(self) -> bool:
        """False: the reference pages full-causal attention stacks only
        (recurrent and sliding-window caches are not position-addressable
        pages, so RecurrentGemma is served in waves there too), and the
        zoo's paged protocol is not ported (ROADMAP queue 1, item 11)."""
        return False

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device).long()

    # --- wave protocol -------------------------------------------------------
    def make_cache(self, batch: int, max_len: int):
        return make_cache(self.cfg, batch, max_len, device=self.device)

    def prefill(self, tokens, cache, lengths=None):
        """Prefill a batch of prompts into ``cache``.  Returns the logits of
        each row's last real prompt token, (B, V), and the cache.
        ``lengths`` (B,) names each row's real length when prompts were
        right-padded to a shared length; None takes the last column."""
        tokens = self._tensor(tokens)
        rows = tokens.shape[1] - 1 if lengths is None else self._tensor(lengths) - 1
        return apply_model(self.params, self.cfg, tokens=tokens, mode="prefill",
                           cache=cache, backend=self.backend, rows=rows)

    def decode(self, tokens, cache, index):
        """One decode step of the batch: tokens (B, 1); index a host int
        (lockstep) or (B,) per-row write positions.  Returns (logits (B, V),
        cache)."""
        if not isinstance(index, int):
            index = self._tensor(index)
        logits, cache = apply_model(self.params, self.cfg, tokens=self._tensor(tokens),
                                    mode="decode", cache=cache, cache_index=index,
                                    backend=self.backend)
        return logits[:, -1], cache


@dataclasses.dataclass
class _Slot:
    """Per-slot decode state."""
    req: Request
    last_token: int
    next_index: int   # absolute position the next decode step writes
    limit: int        # min(max_new_tokens, max_len - prompt_len)


class ServingEngine:
    """Serving engine over an executor.  ``stats`` counts requests,
    prefilled prompt tokens, decode steps and decoded tokens of the
    engine's runs."""

    def __init__(self, executor, *, max_batch: int = 8, max_len: int = 512,
                 sampler: SamplerConfig = SamplerConfig(), rng_seed: int = 0,
                 scheduler: str = "auto", page_size: int = 16,
                 num_pages: Optional[int] = None, record_times: bool = False):
        if scheduler not in ("auto", "continuous", "wave"):
            raise ValueError(f"unknown scheduler {scheduler!r}")
        if scheduler == "continuous" and not getattr(executor, "supports_paged", False):
            raise ValueError("the continuous scheduler needs the paged executor protocol")
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
        self.queue: deque = deque()
        self.stats: Dict[str, int] = {"requests": 0, "prefill_tokens": 0,
                                      "decode_steps": 0, "decode_tokens": 0}
        self.pool: Optional[PagedKVPool] = None

    def submit(self, req: Request) -> None:
        if self.record_times:
            req.submit_time = time.perf_counter()
        self.queue.append(req)
        self.stats["requests"] += 1

    def _sample(self, logits) -> np.ndarray:
        return sample(logits, self.generator, self.sampler).cpu().numpy()

    def _emit(self, r: Request, token: int, limit: int) -> bool:
        """Append one token; returns True if the request just finished."""
        r.output.append(token)
        if self.record_times:
            r.token_times.append(time.perf_counter())
        if (r.eos_id is not None and token == r.eos_id) or len(r.output) >= limit:
            r.done = True
            return True
        return False

    def run(self) -> List[Request]:
        """Drain the queue; returns all completed requests."""
        mode = self.scheduler
        if mode == "auto":
            mode = ("continuous"
                    if getattr(self.executor, "supports_paged", False) else "wave")
        if mode == "continuous":
            return self._run_continuous()
        return self._run_waves()

    def _run_continuous(self) -> List[Request]:
        ex = self.executor
        ps = self.page_size
        n_slots = self.max_batch
        grain = math.lcm(getattr(ex, "prompt_pad_multiple", 1), ps)
        pages_per_slot = _roundup(self.max_len, grain) // ps
        total_pages = self.num_pages or (1 + n_slots * pages_per_slot)
        pool = PagedKVPool(total_pages, ps, n_slots, pages_per_slot)
        storage = ex.make_pool(total_pages, ps)
        self.pool = pool  # introspection (tests / benches)
        slots: List[Optional[_Slot]] = [None] * n_slots
        finished: List[Request] = []

        def admit() -> None:
            nonlocal storage
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
                    continue
                s_pad = _roundup(s, grain)
                max_positions = max(s_pad, s + limit)
                if not pool.can_admit(max_positions):
                    return
                self.queue.popleft()
                pool.admit(slot, initial_positions=s_pad,
                           max_positions=max_positions)
                tokens = np.zeros((1, s_pad), np.int64)
                tokens[0, :s] = r.prompt
                logits, storage = ex.prefill_paged(
                    tokens, storage, pool.block_table[slot].copy(), length=s)
                self.stats["prefill_tokens"] += s
                tok = int(self._sample(logits)[0])
                if self._emit(r, tok, limit):
                    pool.retire(slot)
                    finished.append(r)
                else:
                    slots[slot] = _Slot(r, tok, s, limit)

        admit()
        while any(slots) or self.queue:
            live = [i for i, sl in enumerate(slots) if sl is not None]
            if not live:
                r = self.queue[0]
                raise RuntimeError(
                    f"request uid={r.uid} (prompt {len(r.prompt)}, "
                    f"max_new {r.max_new_tokens}) cannot fit the pool of "
                    f"{total_pages} pages x {ps}"
                )
            tokens = np.zeros((n_slots, 1), np.int64)
            positions = np.zeros(n_slots, np.int64)
            live_mask = np.zeros(n_slots, bool)
            for i in live:
                pool.ensure(i, slots[i].next_index)
                tokens[i, 0] = slots[i].last_token
                positions[i] = slots[i].next_index
                live_mask[i] = True
            # idle rows decode against the null page: their dummy write must
            # not touch real pages
            bt = np.where(live_mask[:, None], pool.block_table, 0)
            logits, storage = ex.decode_paged(tokens, storage, bt, positions)
            self.stats["decode_steps"] += 1
            self.stats["decode_tokens"] += len(live)
            toks = self._sample(logits)
            for i in live:
                sl = slots[i]
                if self._emit(sl.req, int(toks[i]), sl.limit):
                    pool.retire(i)
                    slots[i] = None
                    finished.append(sl.req)
                else:
                    sl.last_token = int(toks[i])
                    sl.next_index += 1
            admit()  # freed slots refill immediately — continuous batching
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
            finished.extend(self._run_wave(wave))
        return finished

    def _run_wave(self, wave: List[Request]) -> List[Request]:
        # zero-budget requests (max_new_tokens=0, prompt filling or exceeding
        # max_len) never emit and never prefill: the cache only holds
        # max_len positions
        for r in wave:
            if min(r.max_new_tokens, self.max_len - len(r.prompt)) <= 0:
                r.done = True
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
        if uniform:
            logits, cache = ex.prefill(tokens, cache)
        else:
            logits, cache = ex.prefill(tokens, cache, lengths=lengths)
        self.stats["prefill_tokens"] += int(lengths.sum())

        active = np.ones(b, bool)
        for step in range(budget):
            next_tok = self._sample(logits)
            for i, r in enumerate(live):
                if active[i] and self._emit(r, int(next_tok[i]), int(limits[i])):
                    active[i] = False
            if not active.any():
                break
            if uniform:
                index = int(lengths[0]) + step
            else:
                # clamp retired rows that out-ran their own length budget;
                # their writes land in a dead cache row and are never read
                index = np.minimum(lengths + step, self.max_len - 1)
            logits, cache = ex.decode(next_tok[:, None], cache, index)
            self.stats["decode_steps"] += 1
            self.stats["decode_tokens"] += int(active.sum())
        for r in live:
            r.done = True
        return wave
