"""One captured program per decode step: the port of the reference's
``jax.jit(decode, donate_argnums=(3,))`` for ``decode_paged``.

The reference compiles the paged decode step once per shape and runs that
one program every step; the port issues each of the step's ops from
Python (576 ``tiled_gemm_valid`` launches and the torch ops around them in
a GPT2-L Galaxy step), and the card waits on the host between them.
:class:`StepGraph` captures the step as one ``torch.cuda.CUDAGraph`` and
replays it.  The block table's width is fixed for a run
(``serving/kvpool.py``: ``(num_slots, pages_per_slot)``), so a serve
captures one graph per executor and pool.

What a captured step may not do, and what keeps it so:

* read a tensor's value on the host, or copy pageable host memory to the
  card: the step takes its inputs from persistent device buffers, filled
  before each replay from pinned host memory;
* allocate a buffer that outlives it from the graph's pool, or build a
  kernel: the first call runs the step eagerly on a side stream (PyTorch's
  warm-up), which builds the kernels (``kernels/build.py:load``) and grows
  the split-K workspace (``kernels/tiled_gemm.py:_workspace``) before the
  capture; both raise if asked to during one;
* outlive what it reads: the graph is bound to the pool's storage and the
  buffers above.  A new pool (the engine makes one a run) or another
  (slots, width) drops the graph and captures again, and the graph holds
  the split-K workspaces it captured, so a later eager launch that grows
  them cannot free them under it.

The kernels' launch counters (``kernels/ops.py:launch_counts``,
``path_counts``) stay true under replay: the capture's own increments are
taken back out and added again on every replay.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import tiled_gemm as _gemm

#: a decode step: ``step(pool, tokens (S, 1), positions (S,), block_table
#: (S, W)) -> logits (S, V)``, updating ``pool`` in place
Step = Callable[..., torch.Tensor]


class CudaRuntime:
    """What :class:`StepGraph` asks of the card.  A test on the CPU hands
    in a stand-in with the same methods."""

    def check(self, device: torch.device) -> torch.device:
        """``device`` with its index, or ``ValueError`` off the card."""
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {device}: "
                             "off the card the decode step runs eagerly (graphs=False)")
        return torch.device("cuda", torch.cuda.current_device() if device.index is None
                            else device.index)

    def host(self, shape) -> torch.Tensor:
        return torch.empty(shape, dtype=torch.int64, pin_memory=True)

    def event(self):
        return torch.cuda.Event()

    def stream(self, device: torch.device):
        return torch.cuda.Stream(device)

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

    def capture(self, stream, fn: Callable[[], torch.Tensor]):
        """A new graph of ``fn`` captured on ``stream`` into a memory pool
        of its own, with ``fn``'s output (the graph's output buffer) and
        the bytes of device memory the pool holds."""
        graph = torch.cuda.CUDAGraph()
        pool = torch.cuda.graph_pool_handle()
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


class StepGraph:
    """The paged decode step of one executor, captured once and replayed.

    ``run(step, pool, tokens, positions, block_table)`` copies the inputs
    into the graph's device buffers (int64: tokens (S, 1), positions (S,),
    block table (S, W), one row of each per slot); host inputs go through
    pinned host memory and one asynchronous copy, device inputs are copied
    on the card.  The first call for a (S, W, pool storage) runs ``step``
    eagerly on a side stream, which is the real step and whose logits are
    returned, then captures it; every later call replays the graph and
    returns a copy of its logits buffer (the next replay overwrites the
    buffer, and the caller may still hold these logits).

    ``stats``: ``captures``, ``replays``, ``capture_ms`` (host wall time of
    the captures), ``pool_bytes`` (device memory the graph's pool holds)
    and ``allocated_bytes`` (``memory_allocated`` after the capture less
    before: what stays allocated for the graph, its output buffer).
    """

    def __init__(self, device, *, runtime: Optional[CudaRuntime] = None):
        self._rt = CudaRuntime() if runtime is None else runtime
        self.device = self._rt.check(torch.device(device))
        self._stream = self._rt.stream(self.device)
        self._copied = None  # the event after the last host-to-device copy
        self._key = None
        self._drop()
        self.stats = {"captures": 0, "replays": 0, "capture_ms": 0.0, "pool_bytes": 0,
                      "allocated_bytes": 0}

    def _drop(self) -> None:
        self._graph = self._out = None
        self._delta = None
        self._keep = ()

    def _buffers(self, s: int, w: int) -> None:
        # one row a slot: [token, position, block-table row]
        self._host = self._rt.host((s, w + 2))
        self._buf = torch.zeros((s, w + 2), dtype=torch.int64, device=self.device)
        self._views = (self._buf[:, :1], self._buf[:, 1], self._buf[:, 2:])

    def _load(self, inputs) -> None:
        on_card = []
        for t in inputs:
            card = isinstance(t, torch.Tensor) and t.device.type != "cpu"
            if card and t.device != self.device:
                raise ValueError(f"a decode input lies on {t.device}; the graph's "
                                 f"buffers are on {self.device}")
            on_card.append(card)
        if not all(on_card):
            if self._copied is not None:
                self._copied.synchronize()  # the last copy has left the host buffer
            host = self._host.numpy()
            for (lo, hi), t, card in zip(((0, 1), (1, 2), (2, None)), inputs, on_card):
                if not card:
                    host[:, lo:hi] = np.asarray(t).reshape(host.shape[0], -1)
            self._buf.copy_(self._host, non_blocking=True)
            if self._copied is None:
                self._copied = self._rt.event()
            self._copied.record()
        for view, t, card in zip(self._views, inputs, on_card):
            if card:
                view.copy_(t.reshape(view.shape))

    def run(self, step: Step, pool, tokens, positions, block_table) -> torch.Tensor:
        s, w = np.shape(block_table)
        key = (s, w, tuple(t.data_ptr() for t in leaves(pool)))
        if key != self._key:
            self._drop()
            self._buffers(s, w)
            self._key = key
        self._load((tokens, positions, block_table))
        if self._graph is not None:
            self._graph.replay()
            _add_counts(self._delta, +1)
            self.stats["replays"] += 1
            return self._out.clone()
        logits = self._rt.warm(self._stream, lambda: step(pool, *self._views))
        before, allocated = _counts(), self._rt.allocated(self.device)
        t0 = time.perf_counter()
        graph, out, held = self._rt.capture(self._stream, lambda: step(pool, *self._views))
        self.stats["capture_ms"] += 1e3 * (time.perf_counter() - t0)
        after = _counts()
        # the capture launched nothing: take its increments back out
        self._delta = {name: (after[name][0] - n, {p: after[name][1][p] - k
                                                   for p, k in paths.items()})
                       for name, (n, paths) in before.items()}
        _add_counts(self._delta, -1)
        self._graph, self._out, self._keep = graph, out, _gemm.workspaces()
        self.stats["captures"] += 1
        self.stats["pool_bytes"] = held
        self.stats["allocated_bytes"] = self._rt.allocated(self.device) - allocated
        return logits
