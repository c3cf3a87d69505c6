"""Per-chip counts of one step run on fake tensors: FLOPs, HBM bytes,
collectives and peak memory (the dry run's counterpart of the reference's
``compiled.cost_analysis()``, HLO collectives and ``memory_analysis()``).

:class:`StepCounter` is a ``TorchDispatchMode`` entered above the fake
tensor mode.  It lets ``DTensor`` ops pass (returns ``NotImplemented``, as
``CommDebugMode`` does), so it sees the local ops each ``DTensor`` op runs
on this rank's shard, the functional collectives of every redistribution
among them.  Each op is counted where it runs:

* FLOPs from ``torch.utils.flop_counter.flop_registry`` on the local
  shapes (matmuls and convolutions; elementwise ops count none).  That is
  the global count divided by the product of the mesh-dim sizes on which
  the output is not replicated (``Shard`` or ``Partial``), and replicated
  work counts on every chip, as the reference's per-device HLO count does.
* Bytes: each op's local operands and results once, views none: the
  unfused count the reference reads from an XLA:CPU compile, in the true
  dtypes.
* Collectives: the local output bytes of each functional collective, by
  kind (the reference's received-volume convention).
* Memory: the bytes of the live local storages (arguments included, each
  freed when its last tensor dies), and their peak.

The model loops over its groups, and the xLSTM over its time steps, in
Python, so every iteration reaches the counter: no loop body is counted
once for many, and the reference's depth extrapolation has no counterpart.

:func:`function` counts a region as one function instead of its ops:
the attention core and the RG-LRU scan, whose plain versions hold
buffers (the (B, H, S, S) fp32 scores; a log-depth scan's passes) that
no kernel of the step moves.  The region's FLOPs and bytes are what any
implementation must do (the live (query, key) pairs' matmuls; inputs read
and outputs written once); its ops still run, so the memory count sees
their buffers, and its collectives still count.
"""
from __future__ import annotations

import contextlib
import sys
import threading
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_STATE = threading.local()

#: functional collective op name -> the reference's collective kind
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}
#: ops that move no data: allocation without a write, aliases
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "_unsafe_view", "detach", "alias",
               "lift_fresh", "new_empty", "new_empty_strided", "set_"}


def active() -> Optional["StepCounter"]:
    """The counter of the step running on this thread, if any."""
    return getattr(_STATE, "counter", None)


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes a tensor's elements span, a broadcast (stride-0) dim once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a ``DTensor``; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


class StepCounter(TorchDispatchMode):
    """Counts the local ops of a step (see the module docstring).  Enter it
    inside ``FakeTensorMode``; read ``flops``, ``bytes``, ``collectives``
    (kind -> bytes), ``peak_bytes``; ``by_op`` and ``bytes_by_op`` hold
    the FLOPs and bytes by op name (``function`` for the regions)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, float] = {}
        self.by_op: Dict[str, float] = {}
        self.bytes_by_op: Dict[str, float] = {}
        self.live = 0
        self.peak_bytes = 0
        self._refs: Dict[int, weakref.ref] = {}
        self._suspended = 0

    # --- memory ---------------------------------------------------------------

    def track(self, tree) -> int:
        """Count the storages of the (local shards of the) tensors in
        ``tree`` as live until they die; returns the bytes newly counted."""
        leaves, _ = tree_flatten(tree)
        added = 0
        for t in leaves:
            if isinstance(t, torch.Tensor):
                added += self._track(local(t))
        return added

    def _track(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs and self._refs[key]() is st:
            return 0
        nbytes = st.nbytes()

        def free(_, key=key, nbytes=nbytes):
            self.live -= nbytes
            self._refs.pop(key, None)

        self._refs[key] = weakref.ref(st, free)
        self.live += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live)
        return nbytes

    # --- regions --------------------------------------------------------------

    @contextlib.contextmanager
    def function(self, flops: float, nbytes: float):
        """Count the ops run inside as one function of ``flops`` FLOPs and
        ``nbytes`` bytes (memory and collectives are still counted)."""
        self.flops += flops
        self.bytes += nbytes
        self.by_op["function"] = self.by_op.get("function", 0.0) + flops
        self.bytes_by_op["function"] = self.bytes_by_op.get("function", 0.0) + nbytes
        self._suspended += 1
        try:
            yield
        finally:
            self._suspended -= 1

    # --- the mode -------------------------------------------------------------

    def __enter__(self):
        self._prev = active()
        _STATE.counter = self
        return super().__enter__()

    def __exit__(self, *exc):
        _STATE.counter = self._prev
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _in_sharding_propagation():
            return out
        name = func._overloadpacket.__name__
        ns = func.namespace
        if ns.startswith("_c10d_functional"):
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                outs, _ = tree_flatten(out)
                nb = sum(tensor_bytes(t) for t in outs if isinstance(t, torch.Tensor))
                self.collectives[kind] = self.collectives.get(kind, 0.0) + nb
        elif not self._suspended and any(isinstance(t, torch.Tensor)
                                         for t in tree_flatten(out)[0]):
            # (an op with no tensor out, as ``prim.device``, reads metadata only)
            fn = flop_registry.get(func._overloadpacket)
            if fn is not None:
                f = float(fn(*args, **kwargs, out_val=out))
                self.flops += f
                self.by_op[name] = self.by_op.get(name, 0.0) + f
            if not func.is_view and name not in _NO_TRAFFIC:
                seen, nb = set(), 0
                for t in tree_flatten((args, kwargs, out))[0]:
                    if isinstance(t, torch.Tensor) and id(t) not in seen:
                        seen.add(id(t))
                        nb += tensor_bytes(t)
                self.bytes += nb
                self.bytes_by_op[name] = self.bytes_by_op.get(name, 0.0) + nb
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out


def _in_sharding_propagation() -> bool:
    """Whether the op runs inside ``DTensor``'s sharding propagation, which
    runs ops on global-shape fake tensors to learn the output's metadata:
    no chip runs them."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


def function(flops: float, nbytes: float):
    """The active counter's :meth:`StepCounter.function`, or a null context
    when no step is counted."""
    counter = active()
    if counter is None:
        return contextlib.nullcontext()
    return counter.function(flops, nbytes)


# --- the functions counted whole -------------------------------------------------

def _tri(n: int) -> int:
    return n * (n + 1) // 2


def live_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs attention must compute: query row r sits at
    position p = r + sk - sq and sees the keys t <= p (causal) with
    t > p - window (window > 0), min(p + 1, window) of them."""
    if not causal:
        return sq * (min(sk, window) if window > 0 else sk)
    first = sk - sq
    if window <= 0:
        return _tri(sk) - _tri(first)
    # rows at p < window see p + 1 keys, the rest see window keys
    low_end = min(sk, window)          # positions first .. low_end - 1
    low = _tri(low_end) - _tri(first) if low_end > first else 0
    return low + window * (sk - max(first, low_end))


def attention_cost(q, k, v, out, *, causal: bool, window: int, backward: bool = False):
    """Per-chip (FLOPs, bytes) of attention q (B, H, Sq, hd) against k/v
    (B, Hkv, Sk, hd) -> out: 4·hd FLOPs a live pair forward (QK^T and PV),
    10·hd backward (the scores again, dV, dP, dQ, dK); the local q, k, v
    and out read or written once (forward), and dout, dq, dk, dv with
    them (backward).  The global count is split over the chips q is
    sharded across."""
    b, h, sq, hd = q.shape
    pairs = live_pairs(sq, k.shape[2], causal, window)
    lq = local(q)
    split = q.numel() / max(lq.numel(), 1)
    flops = (10 if backward else 4) * hd * pairs * b * h / split
    tensors = (q, k, v, out) * (2 if backward else 1)
    return flops, float(sum(tensor_bytes(local(t)) for t in tensors))


def scan_cost(a, b, h0):
    """Per-chip (FLOPs, bytes) of h_t = a_t h_{t-1} + b_t over (B, S, w):
    2 FLOPs an element; a, b and h0 read, h_seq and h_last written once."""
    la, lh = local(a), local(h0)
    nbytes = 3 * tensor_bytes(la) + 2 * tensor_bytes(lh)
    return 2.0 * la.numel(), float(nbytes)
