"""Galaxy HMP executor: serve through the paper-exact schedule.

Bridges the serving engine (``serving/engine.py``) and the heterogeneity-
aware HMP executor (``core/hmp.py``) under the uneven ``ExecPlan`` the
planner produced.  Prefill runs the full TP/SP + ring program over the
ring devices; decode runs the single-token TP step, each device touching
only its own head shard of the cache.  On a
:class:`~repro_torch.core.ring.LocalRing` one executor holds every
device's shards; on a :class:`~repro_torch.core.ring.ProcessRing` each
rank's executor holds its own device's layer and pool shards, and the tied
embedding is replicated: every rank embeds the prompt and computes the
logits from the rows the ring gathers.

Both scheduler protocols are implemented.  Wave: ``make_cache`` /
``prefill`` / ``decode`` against a dense per-wave cache.  Paged
(continuous batching): ``make_pool`` / ``prefill_paged`` / ``decode_paged``
against a pool of head-sharded KV pages, and ``prefill_chunk``, a
grain-aligned chunk at an absolute offset that attends back to the pages
already holding a shared prefix and earlier chunks.  That is what the
engine's prefix cache, chunked prefill and speculative verification
(``serving/spec.py``) call.

The prompt is scattered into the plan's padded ragged layout
(``ExecPlan.seq_layout``) and the output gathered back, so uneven sequence
tiles and non-dividing lengths run exactly.  K/V land at absolute
positions, and each decode step overwrites its own cache entry before
attending, so bucket-padding positions are never read.

``graphs=True`` replays ``decode_paged``, ``prefill_paged``,
``prefill_chunk`` and the wave protocol's ``prefill`` and ``decode`` as
captured CUDA graphs, one per step shape (``serving/graphs.py:StepGraph``,
the reference's jitted decode step, per-padded-length one-shot prefill,
whose length stays a traced scalar, per-chunk-shape prefill, whose offset
does, and per-wave-shape prefill and decode): the one-shot prefill reads
its logits row from device memory, so one graph serves every length that
pads to its shape, the chunk step its offset, so one graph serves every
offset, and the wave decode step its write positions, so one graph
serves every step of a wave.  With graphs on, ``make_pool`` returns the
pool the executor holds for that geometry and user (the engine's target
pool or a speculative draft's), zeroed in place, and
``make_cache`` the wave cache it holds for that batch size, reset in
place, so a paged graph outlives its engine run and a wave graph its
wave.  The
same step functions run eagerly with ``graphs=False``, so the two modes
compute the same thing.  Only a ``LocalRing`` on the card can be
captured: a ``ProcessRing``'s hops synchronize on the host, and it runs
the same steps eagerly.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import hmp
from repro_torch.core.execplan import ExecPlan
from repro_torch.core.ring import ProcessRing, Ring
from repro_torch.serving.graphs import GraphedSteps, shape_of, wave_index, wave_rows


class GalaxyHMPExecutor(GraphedSteps):
    """Wave and paged executor protocols over HMP layers.

    layers: stack of layer params in *reference* layout; padded and split
            once here into the shards of the devices the ring holds (the
            caller may drop the full layers afterwards).
    embed:  (vocab, d_model) tied embedding / unembedding table; its device
            and dtype are the executor's.
    plan:   compute backend and ring transport come from the plan
            (``ExecPlan.with_backend`` / ``with_transport``); prefill always
            runs the overlapped ring.
    graphs: replay ``decode_paged``, ``prefill_paged``, ``prefill_chunk``,
            ``prefill`` and ``decode`` as captured CUDA graphs, and hold one
            paged pool and one wave cache a batch size (settable; setting
            it starts new graphs and ``graph_stats`` and lets the held pool
            and caches go).  Raises ``ValueError`` off the card and on a
            ``ProcessRing``.
    """

    def __init__(self, layers: Sequence[Dict], embed: torch.Tensor,
                 plan: ExecPlan, ring: Ring, *, graphs: bool = False):
        if plan.num_devices != ring.num_devices:
            raise ValueError(f"plan covers {plan.num_devices} devices but the "
                             f"ring has {ring.num_devices}")
        self.plan = plan
        self.ring = ring
        self.layers = [hmp.shard_layer_params(plan, p, ring.devices) for p in layers]
        self.embed = embed
        self.device = embed.device
        self.graphs = graphs

    def _graphs_refused(self) -> Optional[str]:
        if isinstance(self.ring, ProcessRing):
            return ("graphs=True needs a LocalRing: a ProcessRing's hops synchronize on "
                    "the host and cannot be captured")
        return None

    @property
    def prompt_pad_multiple(self) -> int:
        """Plan-derived prompt bucketing grain.  The ragged SP layout makes
        any length correct; bucketing only bounds the distinct shapes."""
        return self.plan.seq_grain

    def wire_stats(self, seq: Optional[int] = None) -> Dict[str, float]:
        """Ring-transport gauges for the engine's metrics registry.

        Prices one full ring rotation of this plan's :class:`RingSchedule`
        at ``seq`` rows (default: one bucketing grain, the smallest shape
        serving ever ships): rows and activation bytes on the wire, and the
        shipped fraction of what padded transport would move.  Static per
        plan: the engine sets them once per run."""
        seq = self.plan.seq_grain if seq is None else seq
        rs = self.plan.ring_schedule(seq)
        row_bytes = self.plan.d_model * self.embed.element_size()
        rows = rs.total_wire_rows()
        return {
            "ring_wire_seq": float(seq),
            "ring_wire_rows": float(rows),
            "ring_wire_rows_padded": float(rs.padded_wire_rows()),
            "ring_wire_bytes": float(rows * row_bytes),
            "ring_wire_fraction": float(rs.wire_fraction()),
        }

    def _tensor(self, a) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.asarray(a))
        return a.to(self.device).long()

    def _lookup(self, tokens: torch.Tensor) -> torch.Tensor:
        """Embedding rows of ``tokens``.  Ids past the table clamp to its
        last row, as the reference's gather does: a draft with a larger
        vocabulary may propose them, and the verifier never accepts one."""
        return self.embed[tokens.clamp(max=self.embed.shape[0] - 1)]

    def _embed(self, tokens: torch.Tensor):
        """Tokens (B, S) -> the ragged layout of S rows and its (B, padded,
        d) embeddings."""
        layout = self.plan.seq_layout(tokens.shape[1])
        return layout, self._lookup(layout.scatter(tokens))

    # --- wave protocol -----------------------------------------------------
    def make_cache(self, batch: int, max_len: int) -> List[Dict]:
        """Dense per-wave cache.  Rows are absolute positions (a ragged
        prefill writes only its valid rows), so it holds the longest
        bucketed prompt, not the plan's padded ragged extent.  With graphs
        on, the cache held for ``batch``, zeroed in place (bitwise a fresh
        one): the caller's earlier wave's cache is this one."""
        grain = self.plan.seq_grain
        cache_len = -(-max_len // grain) * grain
        return self._wave_cache(batch, cache_len, lambda: hmp.make_kv_cache(
            batch, cache_len, len(self.layers), self.plan, device=self.device,
            dtype=self.embed.dtype, devices=self.ring.devices), hmp.reset_kv_cache)

    def prefill(self, tokens, cache, lengths=None):
        """Prefill a wave (B, S), prompts right-padded to S.  Returns the
        logits of each row's last real token, (B, V): row ``lengths[b] -
        1``, or the last column without ``lengths``; and the cache.  The
        step (:meth:`_wave_prefill_step`) runs eagerly or through its
        graph."""
        rows = wave_rows(tokens, lengths)
        return self._step("wave_prefill", self._wave_prefill_step, cache, tokens,
                          rows), cache

    def _wave_prefill_step(self, cache, tokens, rows) -> torch.Tensor:
        """The step that ``prefill`` runs or captures: tokens (B, S) and
        the row of each one's logits, (B,), on the device."""
        layout, x = self._embed(tokens)
        y, _ = hmp.hmp_prefill(self.layers, x, self.ring, cache, plan=self.plan, overlap=True,
                               seq=tokens.shape[1])
        y = layout.gather(y)
        return y[torch.arange(tokens.shape[0], device=self.device), rows] @ self.embed.T

    def decode(self, tokens, cache, index):
        """One lockstep decode step of the wave: tokens (B, 1); index a host
        int (broadcast here to every row) or (B,) per-row write positions.
        Returns (logits (B, V), cache).  The step (:meth:`_decode_step`
        without a block table) runs eagerly or through its graph."""
        return self._step("wave_decode", self._decode_step, cache, tokens,
                          wave_index(tokens, index)), cache

    # --- paged protocol ----------------------------------------------------
    @property
    def supports_paged(self) -> bool:
        return True

    def make_pool(self, num_pages: int, page_size: int, *,
                  user: str = "target") -> List[Dict]:
        """The paged pool; with graphs on, the one held for ``user`` (the
        engine's ``"target"`` or a speculative ``"draft"``) at this
        geometry, zeroed in place (bitwise a fresh one: the decode's
        pad-head reads go to the null page's zero entries), so the graphs
        bound to it outlive the engine run."""
        return self._paged_pool(num_pages, page_size, lambda: hmp.make_kv_cache(
            num_pages, page_size, len(self.layers), self.plan,
            device=self.device, dtype=self.embed.dtype, devices=self.ring.devices,
        ), hmp.reset_kv_cache, user)

    def prefill_paged(self, tokens, pool, block_row, length: int):
        """Prefill one request (batch 1, tokens bucket-padded by the engine)
        writing its K/V straight into its pool pages.  Returns the logits
        of the last real prompt token, (1, V), and the pool.  The row
        ``length - 1`` is checked here, on the host; the step
        (:meth:`_prefill_paged_step`) runs eagerly or through its graph."""
        b, s = shape_of(tokens)
        if b != 1:
            raise ValueError("paged prefill is per-request: batch must be 1")
        length = int(length)
        if not 0 < length <= s:
            raise ValueError(f"length {length} outside the {s} prompt positions")
        return self._step("prefill", self._prefill_paged_step, pool, tokens, block_row,
                          np.array([length - 1])), pool

    def _prefill_paged_step(self, pool, tokens, block_row, row) -> torch.Tensor:
        """The step that ``prefill_paged`` runs or captures: tokens (1, S),
        block_row (W,) and the row of the logits, (1,), all on the device;
        no value is read on the host, so one program serves every length
        that pads to S (the reference's traced ``length``)."""
        layout, x = self._embed(tokens)
        y, _ = hmp.hmp_prefill(self.layers, x, self.ring, pool, plan=self.plan, overlap=True,
                               seq=tokens.shape[1], block_row=block_row)
        return layout.gather(y)[0, row] @ self.embed.T

    def prefill_chunk(self, tokens, pool, block_row, *, offset: int, length: int):
        """One chunked-prefill step (batch 1): the chunk at absolute
        positions [offset, offset + S) through the Galaxy schedule,
        attending back to the pages already written below ``offset`` (a
        shared prefix, earlier chunks, the accepted history of a
        speculative verify), its K/V scattered into its pages.  Returns
        ``(logits, pool)`` with *every* chunk row's logits, (1, S, V): row
        ``j`` predicts position ``offset + j + 1``.  ``length`` (the
        prompt's real length) is the reference's argument; every row is
        returned, so nothing here reads it.  The bounds are checked here,
        on the host; the step (:meth:`_chunk_step`) runs eagerly or
        through its graph."""
        s, w = shape_of(tokens)[1], shape_of(block_row)[0]
        page = pool[0]["k"][0].shape[1]
        offset = int(offset)
        if offset < 0 or offset + s > w * page:
            raise ValueError(f"positions [{offset}, {offset + s}) exceed the block row "
                             f"({w} pages x {page})")
        return self._step("chunk", self._chunk_step, pool, tokens, block_row, offset), pool

    def _chunk_step(self, pool, tokens, block_row, offset) -> torch.Tensor:
        """The step that ``prefill_chunk`` runs or captures: tokens (1, S),
        block_row (W,) and the 0-dim offset, all on the device; no value
        is read on the host, so one program serves every offset.  The
        context is the whole block row, as the reference's."""
        layout, x = self._embed(tokens)
        y, _ = hmp.hmp_prefill(self.layers, x, self.ring, pool, plan=self.plan, overlap=True,
                               seq=tokens.shape[1], block_row=block_row, offset=offset)
        return layout.gather(y) @ self.embed.T

    def decode_paged(self, tokens, pool, block_table, positions):
        """One decode step of the slot batch: tokens (S, 1), block_table
        (S, W), positions (S,).  Returns (logits (S, V), pool); the pool
        is updated in place."""
        return self._step("decode", self._decode_step, pool, tokens, positions,
                          block_table), pool

    def _decode_step(self, pool, tokens, positions, block_table=None) -> torch.Tensor:
        """The step that ``decode_paged`` runs or captures, on device
        tensors, and without ``block_table`` the step of ``decode`` on the
        wave cache; no value is read on the host."""
        x = self._lookup(tokens)  # (S, 1, d)
        y, _ = hmp.hmp_decode(self.layers, x, self.ring, pool, positions, plan=self.plan,
                              block_table=block_table)
        return y[:, -1] @ self.embed.T
