"""Serving engine: continuous batching over a paged KV pool.

A fixed decode batch of ``max_batch`` *slots* over a shared
:class:`~repro_torch.serving.kvpool.PagedKVPool`.  Requests are admitted
from the queue the moment a slot frees (respecting pool capacity), prefill
writes prompt KV straight into pool pages, every decode step advances all
live slots at their own depths, and finished requests retire per-slot
(EOS / max-len), returning their pages for reuse.

The engine drives an *executor* exposing the paged protocol
(``make_pool`` / ``prefill_paged`` / ``decode_paged``) and the
``prompt_pad_multiple`` padding policy.  Prompts pad to
``lcm(prompt_pad_multiple, page_size)``: page-boundary padding costs no
extra pages and bounds the number of distinct prefill shapes.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

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


@dataclasses.dataclass
class _Slot:
    """Per-slot decode state."""
    req: Request
    last_token: int
    next_index: int   # absolute position the next decode step writes
    limit: int        # min(max_new_tokens, max_len - prompt_len)


class ServingEngine:
    """Continuous-batching engine.  ``stats`` counts requests, prefilled
    prompt tokens, decode steps and decoded tokens of the engine's runs."""

    def __init__(self, executor, *, max_batch: int = 8, max_len: int = 512,
                 sampler: SamplerConfig = SamplerConfig(), rng_seed: int = 0,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 record_times: bool = False):
        if not getattr(executor, "supports_paged", False):
            raise ValueError("the engine needs the paged executor protocol")
        self.executor = executor
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
