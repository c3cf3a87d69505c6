"""Speculative decoding on the heterogeneous mesh.

Decode on the Galaxy mesh is a single-token TP step per output token:
every token pays a full ring of tensor synchronizations that batch-1
decode cannot hide behind compute.  Speculative decoding turns k of those
steps into one chunked paged prefill: a small draft model, placed whole on
the fastest device of the cluster (:func:`place_draft` over the planner's
``DeviceSpec`` capacities), proposes ``k`` greedy tokens, and the target
verifies all of them in one ``prefill_chunk`` call of ``k + 1`` rows (the
slot's last emitted token plus the k proposals) at the slot's current
depth.  Logits row ``j`` of that chunk is what non-speculative greedy
decode would produce at position ``offset + j`` given the accepted
history, so:

* accept the longest prefix of proposals matching the per-row argmax
  (:func:`longest_accepted_prefix`);
* the first mismatching row's argmax is the non-speculative token: emit it
  as the correction;
* if every proposal matches, the final row yields a bonus token.

Each round emits between 1 and k + 1 tokens, equal to the non-speculative
greedy output by construction.  Speculation is greedy-only
(``temperature=0``).

Rejected proposals roll back by arithmetic: the K/V a rejected token wrote
sits at positions the scheduler never reads (decode masks keys past its
position, and the next chunk overwrites position ``next_index`` before
attending to it), so rollback truncates the slot's block-table row
(``PagedKVPool.truncate``), releasing the tail pages through the refcount
algebra.

The draft side mirrors the target: :class:`SpeculativeDecoder` owns its own
``PagedKVPool`` and executor storage, prefills each admitted prompt once,
and advances all live slots' proposals as batched paged decode steps of
the draft executor.  After an all-accept round the draft's K/V lags the
target by one position (the k-th proposal was never fed back), so the
next round replays that token first (``gap_tokens``).

Expected emitted tokens per round at per-position acceptance ``a`` is
``1 + a + ... + a^k`` (``core/costmodel.spec_expected_tokens``).

On a ring of processes (``core/ring.ProcessRing``, one rank per cluster
device) the draft lives on the rank of the device ``place_draft`` names:
only that rank builds the :class:`SpeculativeDecoder`, runs the draft's
prefills and proposals, and broadcasts each round's proposals to every
rank (:func:`agree_proposals`).  Every rank then verifies them on its own
shards, and the verify chunk's per-row ids are agreed as the sampled ids
are, so acceptance, emission and the pool move in step on all ranks.

A draft executor with ``graphs`` on replays its one-shot prefills and the
proposals' one-token decode steps as its own captured CUDA graphs
(``serving/graphs.py``), on a pool it holds apart from the target's, also
where the draft is the target's own executor; the verify chunk is the
target's chunk graph.

With a tracer, a round is a ``spec_round`` span holding a
``draft_propose`` span and one ``spec_verify`` span per slot, and a
rejection marks a ``spec_rollback`` event on the request's track; a drift
monitor prices each verify chunk (``"spec_verify"``).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.costmodel import DeviceSpec
from repro_torch.serving.kvpool import PagedKVPool


def place_draft(devices: Sequence[DeviceSpec]) -> int:
    """Draft placement: the index of the highest-FLOPS device.  The draft
    runs unsharded (no ring, no synchronization), so raw single-device
    speed is the only question."""
    if not devices:
        raise ValueError("place_draft needs at least one DeviceSpec")
    return int(max(range(len(devices)), key=lambda i: devices[i].flops))


def longest_accepted_prefix(proposed, verified) -> int:
    """Number of leading positions where the draft matches the verifier."""
    n = 0
    for d, v in zip(proposed, verified):
        if int(d) != int(v):
            break
        n += 1
    return n


class SpeculativeDecoder:
    """Draft-model state for the continuous scheduler.

    Owns the draft executor's paged pool (the target pool's page size and
    block-table geometry, so position arithmetic is shared) and the
    per-slot draft write positions; the engine drives it with the slot
    indices of the target pool.  ``prefills`` and ``steps`` count the
    draft's prefill and batched decode calls."""

    def __init__(self, executor, k: int, *, num_slots: int, page_size: int,
                 pages_per_slot: int):
        if k < 1:
            raise ValueError("spec_k must be >= 1")
        if not getattr(executor, "supports_paged", False):
            raise ValueError("draft executor must implement the paged protocol")
        self.executor = executor
        self.k = k
        self.num_slots = num_slots
        total = 1 + num_slots * pages_per_slot
        self.pool = PagedKVPool(total, page_size, num_slots, pages_per_slot)
        # with graphs on, a pool held apart from the target's, also where
        # the draft is the target's own executor
        self.storage = executor.make_pool(total, page_size, user="draft")
        # next position the draft will write, per slot (-1 = idle)
        self._pos = np.full(num_slots, -1, np.int64)
        self.prefills = 0
        self.steps = 0

    # --- lifecycle (mirrors the target pool) ---------------------------------
    def admit(self, slot: int, tokens: np.ndarray, length: int, *,
              max_positions: int) -> None:
        """One-shot draft prefill of the bucket-padded prompt (1, s_pad)."""
        s_pad = tokens.shape[1]
        self.pool.admit(slot, initial_positions=s_pad,
                        max_positions=max(s_pad, max_positions))
        _, self.storage = self.executor.prefill_paged(
            tokens, self.storage, self.pool.block_table[slot].copy(), length=length)
        self.prefills += 1
        self._pos[slot] = length

    def retire(self, slot: int) -> None:
        self.pool.retire(slot)
        self._pos[slot] = -1

    def observe(self, slot: int, next_index: int) -> None:
        """Record the verifier's outcome for a slot that keeps decoding.

        A rejection leaves the draft ahead of the accepted history: pull it
        back (the stale entries are rewritten before they are read) and
        release the over-allocated tail pages.  An all-accept round leaves
        it one position behind instead (``gap_tokens``)."""
        self._pos[slot] = min(int(self._pos[slot]), next_index)
        self.pool.truncate(slot, int(self._pos[slot]))

    def gap_tokens(self, slot: int, next_index: int, output: List[int],
                   prompt_len: int) -> List[int]:
        """Emitted tokens the draft has not ingested yet (at most one: the
        k-th proposal after an all-accept round)."""
        return [output[p - prompt_len] for p in range(int(self._pos[slot]), next_index)]

    # --- proposal --------------------------------------------------------------
    def propose(self, live: Sequence[int], last_tokens: Dict[int, int],
                positions: Dict[int, int], k_eff: Dict[int, int],
                catchup: Dict[int, List[int]]) -> Dict[int, List[int]]:
        """Advance every live slot's draft by ``k_eff[i]`` greedy proposals.

        Runs ``max(catchup + k_eff)`` batched paged decode steps of the
        draft executor; slots that finish early (or only catch up) are
        masked to the null page like idle slots in the engine's decode
        step.  Returns the proposed tokens per slot."""
        feeds = {i: list(catchup[i]) + [int(last_tokens[i])] for i in live}
        total = {i: len(catchup[i]) + int(k_eff[i]) for i in live}
        drafts: Dict[int, List[int]] = {i: [] for i in live}
        tok = np.zeros((self.num_slots, 1), np.int64)
        pos = np.zeros(self.num_slots, np.int64)
        for j in range(max(total.values(), default=0)):
            active = [i for i in live if j < total[i]]
            if not active:
                break
            mask = np.zeros(self.num_slots, bool)
            for i in active:
                p = int(positions[i]) - len(catchup[i]) + j
                tok[i, 0] = feeds[i][j] if j < len(feeds[i]) else drafts[i][-1]
                pos[i] = p
                self.pool.ensure(i, p)
                mask[i] = True
            bt = np.where(mask[:, None], self.pool.block_table, 0)
            logits, self.storage = self.executor.decode_paged(
                tok, self.storage, bt, np.where(mask, pos, 0))
            self.steps += 1
            nxt = logits.argmax(-1).cpu().numpy()
            for i in active:
                if j >= len(catchup[i]):  # a proposal, not a catch-up step
                    drafts[i].append(int(nxt[i]))
        for i in live:
            self._pos[i] = int(positions[i]) + int(k_eff[i])
        return drafts


def agree_proposals(ring, src: int, drafts: Optional[Dict[int, List[int]]],
                    live: Sequence[int], k: int,
                    k_eff: Dict[int, int]) -> Dict[int, List[int]]:
    """The round's proposals on every rank of ``ring``, from the rank of
    device ``src``, the only one that holds the draft (``drafts`` is None
    on the others).  The broadcast has a shape every rank knows before it,
    ``(len(live), k)`` int64 with each row zero-padded past its
    ``k_eff``, and every rank posts it every round, even when every
    ``k_eff`` is 0, so the ranks' collectives always match."""
    t = torch.zeros((len(live), k), dtype=torch.int64)
    if drafts is not None:
        for row, i in enumerate(live):
            t[row, :k_eff[i]] = torch.as_tensor(drafts[i][:k_eff[i]], dtype=torch.int64)
    t = ring.agree(t, src=src)
    return {i: t[row, :k_eff[i]].tolist() for row, i in enumerate(live)}


def run_spec_round(engine, spec: Optional[SpeculativeDecoder], slots, live,
                   pool: PagedKVPool, storage):
    """One speculative round over the live slots: draft k proposals per
    slot (batched on the draft executor), verify each slot's proposals in
    one chunked paged prefill of the target, emit the accepted prefix plus
    the correction or bonus token, and roll back rejections.  ``spec`` is
    None on a rank of a ring of processes that does not hold the draft:
    it takes the draft rank's proposals (``engine.draft_ring``).

    Returns ``(storage, finished)``, ``finished`` the ``(slot, request)``
    pairs that completed this round (their pages already retired on both
    sides)."""
    ex = engine.executor
    tr = engine._trace
    tracks = engine._tracks
    drift = engine.drift
    k_eff = {}
    for i in live:
        sl = slots[i]
        remaining = sl.limit - len(sl.req.output)
        # never propose past the budget: a request's final token is always
        # the verifier's own (correction or bonus) row
        k_eff[i] = max(0, min(engine.spec_k, remaining - 1))
    if tr is not None:
        tr.begin("engine", "spec_round", live=len(live))
        tr.begin("engine", "draft_propose")
    drafts = None
    if spec is not None:
        catchup = {i: spec.gap_tokens(i, slots[i].next_index, slots[i].req.output,
                                      len(slots[i].req.prompt)) for i in live}
        drafts = spec.propose(live, {i: slots[i].last_token for i in live},
                              {i: slots[i].next_index for i in live}, k_eff, catchup)
    if engine.draft_ring is not None:
        drafts = agree_proposals(engine.draft_ring, engine.draft_device, drafts, live,
                                 engine.spec_k, k_eff)
    if tr is not None:
        tr.end("engine")

    st = engine.stats
    finished = []
    for i in live:
        sl = slots[i]
        ke = k_eff[i]
        chunk = np.zeros((1, ke + 1), np.int64)
        chunk[0, 0] = sl.last_token
        chunk[0, 1:] = drafts[i][:ke]
        pool.ensure(i, sl.next_index + ke)
        if tr is not None:
            tr.begin("engine", "spec_verify", uid=sl.req.uid, k=ke)
        t0 = time.perf_counter() if drift is not None else 0.0
        logits, storage = ex.prefill_chunk(
            chunk, storage, pool.block_table[i].copy(), offset=sl.next_index,
            length=sl.next_index + ke + 1)
        toks = engine._sample_positions(logits)[0]  # (ke + 1,)
        accepted = longest_accepted_prefix(drafts[i][:ke], toks[:ke])
        if drift is not None:
            # per-position sampling copied the tokens to the host, which
            # synced the chunk: the measured time is wall time
            drift.observe("spec_verify", time.perf_counter() - t0,
                          rows=ke + 1, context=sl.next_index + ke + 1)
        if tr is not None:
            tr.end("engine", accepted=accepted)

        emitted, done = 0, False
        for j in range(accepted):
            emitted += 1
            if engine._emit(sl.req, int(drafts[i][j]), sl.limit):
                done = True
                break
        if not done:
            emitted += 1
            done = engine._emit(sl.req, int(toks[accepted]), sl.limit)

        st["spec_steps"] += 1
        st["spec_proposed"] += ke
        st["spec_accepted"] += accepted
        # stats["spec_accept_counts"] reads this histogram back as a
        # value-count dict: observing it is the one write path
        engine.metrics.histogram("spec_accepted_per_round").observe(accepted)
        st["decode_steps"] += 1
        st["decode_tokens"] += emitted

        new_next = sl.next_index + emitted
        if done:
            pool.retire(i)
            if spec is not None:
                spec.retire(i)
            finished.append((i, sl.req))
        else:
            sl.last_token = int(toks[accepted])
            sl.next_index = new_next
            if accepted < ke:
                if tracks is not None:
                    tracks.event(sl.req.uid, "spec_rollback", rejected=ke - accepted)
                pool.truncate(i, new_next)
            if spec is not None:
                spec.observe(i, new_next)
    if tr is not None:
        tr.end("engine")  # spec_round
    return storage, finished
