"""One captured program per step shape: the port of the reference's
per-shape ``jax.jit`` of ``decode_paged``, ``prefill_paged``,
``prefill_chunk`` and the wave protocol's ``prefill`` and ``decode``.

The reference compiles the paged decode step once per shape, the one-shot
paged prefill once per padded length with the prompt's length a traced
scalar, the chunked prefill once per chunk shape with the chunk's offset a
traced scalar, and the wave prefill and decode once per wave shape, and
runs those programs; its compiled programs live on the executor and
outlive every engine run.  The port issues each of a step's ops from
Python (576 ``tiled_gemm_valid`` launches and the torch ops around them
in a GPT2-L Galaxy decode step, 2304 in a prefill, a chunk or a wave
prefill), and the card waits on the host between them.  :class:`StepGraph`
captures a step as one ``torch.cuda.CUDAGraph`` per input shape and
replays it.  The block table's width is fixed for a run
(``serving/kvpool.py``: ``(num_slots, pages_per_slot)``), so a serve
captures one decode graph, one graph per padded prompt length and one per
chunk row count; a wave serve one decode graph per wave batch size.

Five kinds of step, each a function of a cache and int64 inputs of fixed
shapes:

* ``"decode"``: ``step(pool, tokens (S, 1), positions (S,), block_table
  (S, W))``.  Captured on the first call of a shape: every step of a serve
  has the slots' shape.
* ``"prefill"``: ``step(pool, tokens (1, S), block_row (W,), row (1,))``,
  the one-shot paged prefill of a prompt bucket-padded to S: ``row`` is
  its last real token's, ``length - 1``, read on the device, so one graph
  serves every length that pads to S.  Captured on a shape's second call,
  as ``"chunk"``: a padded length met once costs nothing extra, and one
  met in an earlier run of the same pool replays.
* ``"chunk"``: ``step(pool, tokens (1, S), block_row (W,), offset ())``.
  The first call of a shape runs eagerly and is the warm-up; the second
  captures and replays; later calls replay.  A chunk's last, partial
  piece or a one-off verify length costs nothing extra; the full chunks
  and the verify chunk's k + 1 rows repeat.  The offset is an input like
  the tokens, read on the device, so one graph serves every offset.
* ``"wave_decode"``: ``step(cache, tokens (B, 1), index (B,))``, captured
  on the first call of a shape, as ``"decode"``: every step of a wave
  after its first replays.
* ``"wave_prefill"``: ``step(cache, tokens (B, S), rows (B,))``, captured
  on the second call of a shape, as ``"chunk"`` (the reference's key
  ``(b, s, lengths is not None)``; here ``rows`` is always an input).

The paged kinds read a pool that :meth:`StepGraph.paged_pool` holds, one
for each of its users (the engine's target pool, a speculative draft's),
zeroed in place for each run; the wave kinds read a wave cache that
:meth:`StepGraph.wave_cache` holds, one per wave batch size, reset in
place for each wave.  Those are the buffers the reference's jitted
programs reuse, so a graph bound to one outlives the engine run or the
wave, as the reference's compiled programs do.  A graph runs only on a
cache its ``StepGraph`` holds; the executor runs a step on any other
eagerly.  A held pool has one user at a time: an executor with graphs
serves one engine run at a time, and one that drafts for itself holds a
pool for each side.

What a captured step may not do, and what keeps it so:

* read a tensor's value on the host, or copy pageable host memory to the
  card: the step takes its inputs from a persistent device buffer, filled
  before each replay from pinned host memory in one copy, and whatever it
  builds from host data (a layout's row map, its mask) it builds on the
  warm-up call and keeps (``core/execplan.py:SeqLayout.on``);
* allocate a buffer that outlives it from the graph's pool, or build a
  kernel: the warm-up runs the step eagerly on a side stream (PyTorch's
  warm-up), which builds the kernels (``kernels/build.py:load``) and grows
  the split-K workspace (``kernels/tiled_gemm.py:_workspace``) before the
  capture; both raise if asked to during one;
* outlive what it reads: every graph is bound to the storage of the cache
  it reads and to its input buffer.  A held pool's or wave cache's graphs
  go when it does (a pool of another geometry for its user, another
  ``max_len`` for a wave batch size, or a new ``StepGraph``); and each
  graph holds the split-K workspaces it captured, so a later eager launch
  that grows them cannot free them under it.

The graphs of one kind share one memory pool: they run one at a time on
one stream, and a replay's output is copied out before the next replay
may reuse the memory.

The kernels' launch counters (``kernels/ops.py:launch_counts``,
``path_counts``) stay true under replay: the capture's own increments are
taken back out and each graph's are added again on every replay.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import tiled_gemm as _gemm

#: a step: ``step(pool, *inputs) -> logits``, updating ``pool`` in place
Step = Callable[..., torch.Tensor]

#: eager calls of a shape before its capture: a decode step captures on its
#: first call (after the warm-up run in the same call), a one-shot prefill,
#: a chunk or a wave prefill on its second
KINDS = {"decode": 0, "prefill": 1, "chunk": 1, "wave_decode": 0, "wave_prefill": 1}
#: the kinds that read the engine's paged pool; the others a held wave cache
PAGED = ("decode", "prefill", "chunk")
#: the stats of a kind that add up over calls; the others are levels
COUNTED = ("shapes", "captures", "replays", "capture_ms", "allocated_bytes")


class CudaRuntime:
    """What :class:`StepGraph` asks of the card.  A test on the CPU hands
    in a stand-in with the same methods."""

    def check(self, device: torch.device) -> torch.device:
        """``device`` with its index, or ``ValueError`` off the card."""
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {device}: "
                             "off the card the steps run eagerly (graphs=False)")
        return torch.device("cuda", torch.cuda.current_device() if device.index is None
                            else device.index)

    def host(self, shape) -> torch.Tensor:
        return torch.empty(shape, dtype=torch.int64, pin_memory=True)

    def event(self):
        return torch.cuda.Event()

    def stream(self, device: torch.device):
        return torch.cuda.Stream(device)

    def pool(self):
        """A new memory pool for graphs to share."""
        return torch.cuda.graph_pool_handle()

    def warm(self, stream, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        """``fn()`` on ``stream`` after the current stream's work, which
        then waits for it; the result is handed to the current stream."""
        cur = torch.cuda.current_stream(stream.device)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            out = fn()
        cur.wait_stream(stream)
        out.record_stream(cur)
        return out

    def capture(self, stream, fn: Callable[[], torch.Tensor], pool):
        """A new graph of ``fn`` captured on ``stream`` into memory pool
        ``pool``, with ``fn``'s output (the graph's output buffer) and the
        bytes of device memory the pool holds after it."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            out = fn()
        held = sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == tuple(pool))
        return graph, out, held

    def allocated(self, device: torch.device) -> int:
        return torch.cuda.memory_allocated(device)


def leaves(tree):
    """The tensors of a pool's tree (dicts, lists and tuples of tensors)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)


def _counts() -> Dict[str, Tuple[int, Dict[str, int]]]:
    return {name: (fn.launches, dict(fn.paths)) for name, fn in ops.KERNELS.items()}


def _add_counts(delta: Dict[str, Tuple[int, Dict[str, int]]], sign: int) -> None:
    for name, (n, paths) in delta.items():
        fn = ops.KERNELS[name]
        fn.launches += sign * n
        for path, k in paths.items():
            fn.paths[path] += sign * k


def shape_of(t) -> Tuple[int, ...]:
    """The shape of a tensor, an array, a list or a scalar (no copy)."""
    return tuple(t.shape) if isinstance(t, torch.Tensor) else np.shape(t)


def wave_rows(tokens, lengths) -> np.ndarray:
    """The row of each wave prompt's logits, (B,) int64: ``lengths - 1``,
    or without ``lengths`` the last column, S - 1, broadcast on the host."""
    b, s = shape_of(tokens)
    if lengths is None:
        return np.full((b,), s - 1, np.int64)
    return (lengths if isinstance(lengths, torch.Tensor)
            else np.asarray(lengths, np.int64)) - 1


def wave_index(tokens, index):
    """A wave decode step's write positions, (B,): a lockstep index
    broadcast to every row on the host, per-row ones as given."""
    if shape_of(index) != ():
        return index
    return np.full((shape_of(tokens)[0],), int(index), np.int64)


@dataclasses.dataclass
class _Entry:
    """One input shape of one kind: its buffers and, once captured, its
    graph."""
    host: torch.Tensor  # pinned, flat: every input's values in turn
    buf: torch.Tensor  # the device copy the step reads
    views: Tuple[torch.Tensor, ...]  # the inputs, shaped, in ``buf``
    calls: int = 0
    copied: object = None  # the event after the last host-to-device copy
    graph: object = None
    out: Optional[torch.Tensor] = None
    delta: Optional[Dict] = None  # the launches one replay makes
    keep: tuple = ()  # the split-K workspaces the graph launches on


def storage(tree) -> Tuple:
    """Where a cache tree lives: each leaf's address and shape.  A graph
    reads exactly these."""
    return tuple((t.data_ptr(), tuple(t.shape)) for t in leaves(tree))


def _fresh_stats() -> Dict[str, Dict]:
    stats = {kind: {"shapes": 0, "captures": 0, "replays": 0, "capture_ms": 0.0,
                    "pool_bytes": 0, "allocated_bytes": 0} for kind in KINDS}
    stats["wave_caches"] = {"caches": 0, "bytes": 0}
    stats["paged_pool"] = {"pools": 0, "bytes": 0}
    return stats


def stats_since(before: Optional[Dict], after: Optional[Dict]) -> Optional[Dict]:
    """``graph_stats`` ``after`` less ``before`` where they add up over
    calls (``COUNTED``: what happened in between, one engine run's own);
    the levels (pool bytes, the held caches and pool) as ``after`` has
    them.  ``after`` itself where ``before`` is None."""
    if after is None or before is None:
        return after
    return {kind: {k: v - before[kind][k] if kind in KINDS and k in COUNTED else v
                   for k, v in st.items()} for kind, st in after.items()}


class StepGraph:
    """The captured steps of one executor, one graph per (cache, kind,
    input shapes), each bound to the storage of the cache it reads, and
    the caches those graphs outlive runs on: one paged pool a user
    (:meth:`paged_pool`) and one wave cache a batch size
    (:meth:`wave_cache`).

    ``run(step, cache, *inputs, kind=)`` copies the int64 inputs into the
    shape's device buffer (host inputs through pinned host memory and one
    asynchronous copy, device inputs on the card), then runs ``step(cache,
    *views)`` eagerly on a side stream (the warm-up), captures it, or
    replays its graph, as ``KINDS`` says for the kind.  A replay returns a
    copy of the graph's logits buffer (the next replay may overwrite it,
    and the caller may still hold these logits).  The paged kinds take a
    pool from :meth:`paged_pool`, the wave kinds a cache from
    :meth:`wave_cache`; ``run`` refuses any other (:meth:`binds`).

    ``stats[kind]``: ``shapes`` (input shapes met on a cache, counted again
    on a new one), ``captures``, ``replays``, ``capture_ms`` (host wall
    time of the captures), ``pool_bytes`` (device memory the kind's shared
    graph pool holds) and ``allocated_bytes`` (``memory_allocated`` after
    each capture less before, summed: what stays allocated for the graphs,
    their output buffers); ``stats["wave_caches"]``: the held wave caches
    and their bytes; ``stats["paged_pool"]``: the held pools (one a user)
    and their bytes.  The counts add up over the ``StepGraph``'s life
    (:func:`stats_since` takes one run's).
    """

    def __init__(self, device, *, runtime: Optional[CudaRuntime] = None):
        self._rt = CudaRuntime() if runtime is None else runtime
        self.device = self._rt.check(torch.device(device))
        self._stream = self._rt.stream(self.device)
        self._entries: Dict[Tuple, _Entry] = {}  # by (storage, kind, input shapes)
        self._pools: Dict[str, object] = {}
        # ("wave", batch) or ("paged", user) -> (size, cache, storage)
        self._held: Dict[object, Tuple[object, object, Tuple]] = {}
        self.stats = _fresh_stats()

    def _release(self, where) -> None:
        """Drop every graph bound to storage ``where``."""
        for key in [k for k in self._entries if k[0] == where]:
            del self._entries[key]

    def wave_cache(self, batch: int, max_len: int, make: Callable[[], object],
                   reset: Callable[[object], None]):
        """The wave cache held for ``batch`` rows of ``max_len`` positions,
        reset in place (``reset(cache)``), or ``make()``'s new one where
        none is held at that size; a cache of another ``max_len`` for the
        batch is let go with its graphs.  One cache a batch size."""
        return self._hold(("wave", batch), max_len, make, reset)

    def paged_pool(self, num_pages: int, page_size: int, make: Callable[[], object],
                   reset: Callable[[object], None], user: str = "target"):
        """The paged pool held for ``user`` at this geometry, zeroed in
        place (``reset(pool)``), or ``make()``'s new one; the user's pool
        of another geometry is let go with its graphs.  One pool a user
        (the engine's ``"target"``, a speculative ``"draft"``): its graphs
        outlive the engine run that made it, and no two users share it."""
        return self._hold(("paged", user), (num_pages, page_size), make, reset)

    def _hold(self, slot, size, make, reset):
        held = self._held.get(slot)
        if held is not None and held[0] == size:
            reset(held[1])
            return held[1]
        if held is not None:
            self._release(held[2])
        cache = make()
        self._held[slot] = (size, cache, storage(cache))
        for name, held_as, count in (("wave_caches", "wave", "caches"),
                                     ("paged_pool", "paged", "pools")):
            caches = [c for k, (_, c, _) in self._held.items() if k[0] == held_as]
            self.stats[name] = {count: len(caches),
                                "bytes": sum(t.numel() * t.element_size()
                                             for c in caches for t in leaves(c))}
        return cache

    def binds(self, cache) -> bool:
        """Whether graphs may run on ``cache``: a pool or wave cache this
        ``StepGraph`` holds."""
        where = storage(cache)
        return any(where == s for _, _, s in self._held.values())

    def _entry(self, shapes: Sequence[Tuple[int, ...]]) -> _Entry:
        sizes = [math.prod(s) for s in shapes]
        host = self._rt.host((sum(sizes),))
        buf = torch.zeros((sum(sizes),), dtype=torch.int64, device=self.device)
        views, lo = [], 0
        for shape, n in zip(shapes, sizes):
            views.append(buf[lo:lo + n].view(shape))
            lo += n
        return _Entry(host, buf, tuple(views))

    def _load(self, e: _Entry, inputs) -> None:
        on_card = []
        for t in inputs:
            card = isinstance(t, torch.Tensor) and t.device.type != "cpu"
            if card and t.device != self.device:
                raise ValueError(f"a step input lies on {t.device}; the graph's "
                                 f"buffers are on {self.device}")
            on_card.append(card)
        if not all(on_card):
            if e.copied is not None:
                e.copied.synchronize()  # the last copy has left the host buffer
            host, lo = e.host.numpy(), 0
            for view, t, card in zip(e.views, inputs, on_card):
                n = view.numel()
                if not card:
                    host[lo:lo + n] = np.asarray(t).reshape(-1)
                lo += n
            e.buf.copy_(e.host, non_blocking=True)
            if e.copied is None:
                e.copied = self._rt.event()
            e.copied.record()
        for view, t, card in zip(e.views, inputs, on_card):
            if card:
                view.copy_(t.reshape(view.shape))

    def run(self, step: Step, pool, *inputs, kind: str = "decode") -> torch.Tensor:
        if kind not in KINDS:
            raise ValueError(f"unknown step kind {kind!r}; one of {sorted(KINDS)}")
        if not self.binds(pool):
            held = "pool (paged_pool)" if kind in PAGED else "wave cache (wave_cache)"
            raise ValueError(f"a {kind} graph runs on a {held} this StepGraph holds")
        shapes = tuple(shape_of(t) for t in inputs)
        key = (storage(pool), kind, shapes)
        e = self._entries.get(key)
        stats = self.stats[kind]
        if e is None:
            e = self._entries[key] = self._entry(shapes)
            stats["shapes"] += 1
        self._load(e, inputs)
        if e.graph is None:
            e.calls += 1
            if e.calls <= KINDS[kind]:
                return self._rt.warm(self._stream, lambda: step(pool, *e.views))
            logits = None
            if KINDS[kind] == 0:
                logits = self._rt.warm(self._stream, lambda: step(pool, *e.views))
            self._capture(e, kind, step, pool)
            if logits is not None:
                return logits
        e.graph.replay()
        _add_counts(e.delta, +1)
        stats["replays"] += 1
        return e.out.clone()

    def _capture(self, e: _Entry, kind: str, step: Step, pool) -> None:
        stats = self.stats[kind]
        if kind not in self._pools:
            self._pools[kind] = self._rt.pool()
        before, allocated = _counts(), self._rt.allocated(self.device)
        t0 = time.perf_counter()
        graph, out, held = self._rt.capture(self._stream, lambda: step(pool, *e.views),
                                            self._pools[kind])
        stats["capture_ms"] += 1e3 * (time.perf_counter() - t0)
        after = _counts()
        # the capture launched nothing: take its increments back out
        e.delta = {name: (after[name][0] - n, {p: after[name][1][p] - k
                                               for p, k in paths.items()})
                   for name, (n, paths) in before.items()}
        _add_counts(e.delta, -1)
        e.graph, e.out, e.keep = graph, out, _gemm.workspaces()
        stats["captures"] += 1
        stats["pool_bytes"] = held
        stats["allocated_bytes"] += self._rt.allocated(self.device) - allocated


class GraphedSteps:
    """An executor's side of :class:`StepGraph`: the settable ``graphs``
    (setting it starts a new ``StepGraph``, new ``graph_stats`` and no held
    pool or wave cache), ``graph_stats``, :meth:`_step`, :meth:`_wave_cache`
    and :meth:`_paged_pool`.
    The executor sets ``device`` and defines ``_tensor`` (an input as an
    int64 tensor on its device) and ``_graphs_refused`` (why it cannot be
    captured, or None)."""

    _graph: Optional[StepGraph] = None

    @property
    def graphs(self) -> bool:
        return self._graph is not None

    @graphs.setter
    def graphs(self, on: bool) -> None:
        self._graph = None
        if on:
            why = self._graphs_refused()
            if why is not None:
                raise ValueError(why)
            self._graph = StepGraph(self.device)

    @property
    def graph_stats(self) -> Optional[Dict]:
        """The captured steps' ``StepGraph.stats``: ``decode``, ``prefill``,
        ``chunk``, ``wave_decode``, ``wave_prefill``, ``wave_caches`` and
        ``paged_pool``, over the graphs' life (None without graphs)."""
        return None if self._graph is None else {k: dict(v)
                                                 for k, v in self._graph.stats.items()}

    def _step(self, kind: str, step: Step, cache, *inputs) -> torch.Tensor:
        """``step(cache, *inputs)``: through the graph of its shape where
        graphs are on and bind ``cache``, else eagerly on the inputs moved
        to the device.  Both run the same step."""
        if self._graph is not None and self._graph.binds(cache):
            return self._graph.run(step, cache, *inputs, kind=kind)
        return step(cache, *(self._tensor(t) for t in inputs))

    def _wave_cache(self, batch: int, max_len: int, make: Callable[[], object],
                    reset: Callable[[object], None]):
        """``make()`` without graphs; with them the held cache of
        ``StepGraph.wave_cache``, reset in place."""
        if self._graph is None:
            return make()
        return self._graph.wave_cache(batch, max_len, make, reset)

    def _paged_pool(self, num_pages: int, page_size: int, make: Callable[[], object],
                    reset: Callable[[object], None], user: str):
        """``make()`` without graphs; with them ``user``'s held pool of
        ``StepGraph.paged_pool``, zeroed in place."""
        if self._graph is None:
            return make()
        return self._graph.paged_pool(num_pages, page_size, make, reset, user)
