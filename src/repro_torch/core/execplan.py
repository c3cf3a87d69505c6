"""Execution plans: materialize a ``planner.Plan`` into a runnable program.

The planner (Alg. 1) emits *uneven* integer shard counts — heads per device
for MHA, columns per device for MLP — while each ring device's tensors are
easiest to run at one shape.  An :class:`ExecPlan` closes that gap with
pad-and-mask materialization:

* every device's head slice is padded to ``max(heads)`` and every column
  slice to ``max(columns)`` with **zeroed weights**, so the math stays exact;
* the sequence axis gets the same treatment (:class:`SeqLayout`): the
  planner's uneven per-device sequence tiles are padded to ``max(tile)``
  rows, real rows scattered to per-device offsets, and the pad rows masked
  out of the ring schedule (``core/ring.py``) and the attention.

``compute_backend`` picks the per-shard compute path: ``"eager"`` runs the
padded shards as dense masked PyTorch ops (every device executes
``max(units)`` work; the correctness oracle), ``"kernel"`` routes every
shard GEMM, the prefill attention and the connective blocks through the
hand-written kernels of ``kernels/``, which skip pad blocks.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import planner
from repro_torch.core.ring import RING_TRANSPORTS, RingSchedule

#: per-shard compute paths (see module docstring)
COMPUTE_BACKENDS = ("eager", "kernel")

#: the reference package's backend names and their counterparts here: its
#: padded XLA oracle is "eager", its pad-shedding Pallas path is "kernel"
REFERENCE_BACKENDS = {"xla": "eager", "pallas": "kernel"}

# which axis of each layer parameter is partitioned, and by which unit kind
_PARTITIONED_AXES = {
    "wq": ("head", 1),
    "wk": ("head", 1),
    "wv": ("head", 1),
    "wo": ("head", 0),
    "w1": ("column", 1),
    "w2": ("column", 0),
}


@dataclasses.dataclass(frozen=True)
class SeqLayout:
    """Padded ragged layout of one global sequence over the ring devices.

    ``tiles[d]`` real rows belong to device ``d``; every device's shard is
    padded to ``pad_tile = max(tiles)`` rows.  Real position ``p`` lives at
    padded row ``rows[p]``; pad rows carry no position (``positions ==
    -1``).  For an equal split of a dividing sequence the layout is dense.
    """

    tiles: Tuple[int, ...]

    @property
    def num_devices(self) -> int:
        return len(self.tiles)

    @property
    def seq(self) -> int:
        """Logical (unpadded) sequence length: sum of the valid tiles."""
        return sum(self.tiles)

    @property
    def pad_tile(self) -> int:
        """Rows each device's shard holds after padding."""
        return max(self.tiles)

    @property
    def padded_len(self) -> int:
        return self.num_devices * self.pad_tile

    @property
    def is_dense(self) -> bool:
        return self.padded_len == self.seq

    @functools.cached_property
    def rows(self) -> np.ndarray:
        """(seq,) padded-row index of each real position."""
        return np.concatenate(
            [d * self.pad_tile + np.arange(t, dtype=int)
             for d, t in enumerate(self.tiles)]
        ) if self.seq else np.zeros(0, int)

    @functools.cached_property
    def positions(self) -> np.ndarray:
        """(padded_len,) real position of each padded row; -1 for pad rows."""
        pos = np.full(self.padded_len, -1, int)
        pos[self.rows] = np.arange(self.seq)
        return pos

    @functools.cached_property
    def valid(self) -> np.ndarray:
        """(padded_len,) bool: which padded rows hold real positions."""
        return self.positions >= 0

    def attention_mask(self) -> np.ndarray:
        """(padded_len, padded_len) bool causal mask in the padded domain.

        Real query rows attend causally to real key rows; pad query rows
        attend everywhere (their garbage stays confined to pad rows and an
        all-masked softmax row would go NaN)."""
        pos = self.positions
        causal = self.valid[None, :] & (pos[None, :] <= pos[:, None])
        return np.where(self.valid[:, None], causal, True)

    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        """(B, seq, ...) real layout -> (B, padded_len, ...) padded layout
        (pad rows zero).  Identity for dense layouts."""
        if self.is_dense:
            return x
        out = x.new_zeros((x.shape[0], self.padded_len, *x.shape[2:]))
        out[:, torch.as_tensor(self.rows, device=x.device)] = x
        return out

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """(B, padded_len, ...) padded layout -> (B, seq, ...) real layout."""
        if self.is_dense:
            return y
        return y[:, torch.as_tensor(self.rows, device=y.device)]


@dataclasses.dataclass(frozen=True)
class ExecPlan:
    """A runnable materialization of one layer-parallel partition.

    heads:      MHA heads assigned per device (sums to the model's head count)
    columns:    MLP columns assigned per device (sums to d_ff)
    seq_shares: relative sequence-tile weights per device (the planner's
                ``Plan.seq``); empty means the equal split.
    compute_backend: per-shard compute path (``COMPUTE_BACKENDS``).
    transport:  ring wire format (``ring.RING_TRANSPORTS``).
    double_buffer: issue each ring hop before the GEMM that frees its buffer.
    """

    heads: Tuple[int, ...]
    columns: Tuple[int, ...]
    head_dim: int
    d_model: int
    seq_shares: Tuple[float, ...] = ()
    compute_backend: str = "eager"
    transport: str = "padded"
    double_buffer: bool = False

    def __post_init__(self):
        if self.compute_backend not in COMPUTE_BACKENDS:
            raise ValueError(
                f"unknown compute_backend {self.compute_backend!r}; "
                f"one of {COMPUTE_BACKENDS}"
            )
        if self.transport not in RING_TRANSPORTS:
            raise ValueError(
                f"unknown transport {self.transport!r}; "
                f"one of {RING_TRANSPORTS}"
            )
        if len(self.heads) != len(self.columns):
            raise ValueError(
                f"heads ({len(self.heads)}) and columns ({len(self.columns)}) "
                "must cover the same device list"
            )
        if not self.heads:
            raise ValueError("ExecPlan needs at least one device")
        if min(self.heads) < 0 or min(self.columns) < 0:
            raise ValueError("shard counts must be non-negative")
        if max(self.heads) == 0 or max(self.columns) == 0:
            raise ValueError("at least one device must hold a nonzero shard")
        if self.seq_shares:
            if len(self.seq_shares) != len(self.heads):
                raise ValueError(
                    f"seq_shares ({len(self.seq_shares)}) must cover the "
                    f"same {len(self.heads)} devices"
                )
            if min(self.seq_shares) < 0 or sum(self.seq_shares) <= 0:
                raise ValueError("seq_shares must be non-negative, sum > 0")

    # --- constructors ---------------------------------------------------------
    @classmethod
    def from_plan(cls, plan_: planner.Plan, *, head_dim: int, d_model: int,
                  compute_backend: str = "eager") -> "ExecPlan":
        if not plan_.feasible:
            raise ValueError(f"cannot materialize an infeasible plan: {plan_.reason}")
        return cls(
            heads=tuple(int(a) for a in plan_.mha),
            columns=tuple(int(b) for b in plan_.mlp),
            head_dim=head_dim,
            d_model=d_model,
            seq_shares=tuple(float(s) for s in plan_.seq),
            compute_backend=compute_backend,
        )

    def with_backend(self, compute_backend: str) -> "ExecPlan":
        """The same plan routed through another per-shard compute path."""
        return dataclasses.replace(self, compute_backend=compute_backend)

    def with_transport(self, transport: str = None, *,
                       double_buffer: bool = None) -> "ExecPlan":
        """The same plan with a different ring wire format / overlap mode."""
        return dataclasses.replace(
            self,
            transport=self.transport if transport is None else transport,
            double_buffer=(self.double_buffer if double_buffer is None
                           else double_buffer),
        )

    # --- derived geometry -----------------------------------------------------
    @property
    def num_devices(self) -> int:
        return len(self.heads)

    @property
    def num_heads(self) -> int:
        return sum(self.heads)

    @property
    def d_ff(self) -> int:
        return sum(self.columns)

    @property
    def pad_heads(self) -> int:
        """Per-device head slots after padding (= straggler's head count)."""
        return max(self.heads)

    @property
    def pad_columns(self) -> int:
        return max(self.columns)

    @property
    def padded_heads(self) -> int:
        """Global head count of the padded parameter arrays."""
        return self.num_devices * self.pad_heads

    @property
    def padded_ff(self) -> int:
        return self.num_devices * self.pad_columns

    # --- sequence geometry (ragged SP axis) -----------------------------------
    @property
    def seq_fractions(self) -> np.ndarray:
        """(D,) normalized sequence shares; equal split when unset."""
        if not self.seq_shares:
            return np.full(self.num_devices, 1.0 / self.num_devices)
        s = np.asarray(self.seq_shares, float)
        return s / s.sum()

    def seq_tiles(self, seq: int) -> Tuple[int, ...]:
        """Integer per-device sequence tiles for a given length (sum = seq)."""
        return tuple(
            int(t) for t in planner._largest_remainder_round(
                self.seq_fractions * seq, seq)
        )

    def seq_layout(self, seq: int) -> SeqLayout:
        """Padded ragged layout of a ``seq``-row sequence under this plan."""
        return SeqLayout(self.seq_tiles(seq))

    @property
    def seq_grain(self) -> int:
        """Prompt-length bucketing grain for serving.  ``seq_layout`` covers
        every length, so this only bounds the number of distinct shapes."""
        return self.num_devices

    # --- ring transport (what the hops ship) ----------------------------------
    def ring_schedule(self, seq: int = None, *, layout: SeqLayout = None,
                      gemm=None) -> RingSchedule:
        """The ring program this plan's hops run for one sequence: tile
        geometry from ``seq_layout``, wire format and overlap mode from the
        plan's ``transport`` / ``double_buffer``."""
        if layout is None:
            if seq is None:
                raise ValueError("ring_schedule needs seq= or layout=")
            layout = self.seq_layout(seq)
        return RingSchedule.ragged(
            layout.tiles, pad_tile=layout.pad_tile, transport=self.transport,
            double_buffer=self.double_buffer, gemm=gemm,
        )

    # --- parameter materialization --------------------------------------------
    def _counts(self, kind: str) -> Tuple[Sequence[int], int]:
        return (self.heads, self.pad_heads) if kind == "head" else (
            self.columns, self.pad_columns)

    def _pad_axis(self, arr: torch.Tensor, kind: str, axis: int) -> torch.Tensor:
        counts, pad = self._counts(kind)
        shape = list(arr.shape)
        shape[axis] = len(counts) * pad
        out = arr.new_zeros(shape)
        off = 0
        for d, c in enumerate(counts):
            if c:
                out.narrow(axis, d * pad, c).copy_(arr.narrow(axis, off, c))
                off += c
        return out

    def pad_layer_params(self, p: Dict) -> Dict:
        """Reference-layout layer params -> device-contiguous padded params.

        Device ``d`` owns heads ``[sum(heads[:d]), sum(heads[:d+1]))`` of the
        original arrays, placed at slots ``[d*pad_heads, ...)`` of the padded
        arrays; pad slots are zero, so every block's output is exact.
        """
        self._check_reference(p)
        out = dict(p)
        for name, (kind, axis) in _PARTITIONED_AXES.items():
            out[name] = self._pad_axis(p[name], kind, axis)
        return out

    def _check_reference(self, p: Dict) -> None:
        if p["wq"].shape[1] != self.num_heads or p["wq"].shape[2] != self.head_dim:
            raise ValueError(
                f"params have {p['wq'].shape[1]}x{p['wq'].shape[2]} heads, "
                f"plan expects {self.num_heads}x{self.head_dim}"
            )
        if p["w1"].shape[1] != self.d_ff:
            raise ValueError(
                f"params have d_ff={p['w1'].shape[1]}, plan expects {self.d_ff}"
            )

    def is_padded(self, p: Dict) -> bool:
        """True if ``p`` is already in this plan's padded layout."""
        return (
            p["wq"].shape[1] == self.padded_heads
            and p["w1"].shape[1] == self.padded_ff
        )

    def ensure_padded(self, p: Dict) -> Dict:
        """Accept either layout; return padded params."""
        if self.is_padded(p):
            return p
        return self.pad_layer_params(p)

    def describe(self) -> str:
        f = self.seq_fractions
        seq = "seq=[" + ",".join(f"{x:.0%}" for x in f) + "]"
        return (
            f"ExecPlan(n={self.num_devices}, heads={list(self.heads)}"
            f"->pad {self.pad_heads}, columns={list(self.columns)}"
            f"->pad {self.pad_columns}, {seq}, "
            f"backend={self.compute_backend}, transport={self.transport}"
            f"{'+db' if self.double_buffer else ''})"
        )
