"""Heterogeneity and Memory Aware Workload Planning (paper §III-C, Alg. 1).

Two-step heuristic:

1. ``balanced_partition`` — MHA heads / MLP columns proportional to each
   device's computing capacity V_d (Eq. 6), ignoring memory.
2. ``memory_aware_balancing`` — recursively shift the overflowing workload
   of OOM devices to devices with headroom, proportional to the free
   devices' capacities; MLP first (finer granularity), then MHA.  If OOM
   persists, planning fails.

The SP axis is the equal split of §III-C-2 unless per-device links are
given; then ``sequence_partition`` solves uneven sequence tiles that trade
the straggler connective time against the ragged-ring exchange time.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core import costmodel


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    name: str
    capacity: float        # V_d = 1 / (L(MHA, full, d) + L(MLP, full, d))  [Eq. 6]
    memory_budget: float   # bytes available for model weights


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """Per-layer workload/memory profile (from ``core.profiler``)."""
    name: str
    num_layers: int
    num_heads: int         # MHA partition granularity (paper: head dim)
    mlp_columns: int       # MLP partition granularity (paper: column dim)
    m_att: float           # bytes of one full MHA block's weights
    m_mlp: float           # bytes of one full MLP block's weights


@dataclasses.dataclass
class Plan:
    mha: np.ndarray        # heads per device   (A)
    mlp: np.ndarray        # columns per device (B)
    seq: np.ndarray        # sequence fractions (S)
    feasible: bool
    reason: str = ""
    # sequence fraction each ring hop ships per device (bucketed transport,
    # ``ExecPlan.wire_fractions``); None: the hops ship ``seq``
    seq_wire: Optional[np.ndarray] = None

    def memory_per_device(self, model: ModelProfile) -> np.ndarray:
        """Weight bytes each device holds under this plan (all layers)."""
        a = self.mha / max(self.mha.sum(), 1)
        b = self.mlp / max(self.mlp.sum(), 1)
        return model.num_layers * (model.m_att * a + model.m_mlp * b)


def _largest_remainder_round(shares: np.ndarray, total: int) -> np.ndarray:
    """Round non-negative real shares to integers preserving the sum."""
    floor = np.floor(shares).astype(int)
    rem = shares - floor
    short = total - floor.sum()
    order = np.argsort(-rem)
    out = floor.copy()
    for i in range(int(short)):
        out[order[i % len(order)]] += 1
    return out


def balanced_partition(total_units: int, capacities: Sequence[float]) -> np.ndarray:
    """Alg. 1 lines 1-8: workload proportional to computing capacity."""
    v = np.asarray(capacities, dtype=float)
    shares = v / v.sum() * total_units
    return _largest_remainder_round(shares, total_units)


def memory_aware_balancing(
    units: np.ndarray,
    unit_mem: float,
    capacities: Sequence[float],
    budgets: Sequence[float],
    other_mem: np.ndarray,
    active: Optional[List[int]] = None,
) -> Optional[np.ndarray]:
    """Alg. 1 lines 9-19, for one block type T.

    units:     integer workload units currently assigned per device
    unit_mem:  bytes of model weights per workload unit (l * M_T / total_T)
    other_mem: bytes per device already committed by the *other* block type
    active:    list L of candidate devices (shrinks on recursion)

    Returns the rebalanced units, or None if infeasible.
    """
    units = units.copy().astype(int)
    v = np.asarray(capacities, dtype=float)
    budgets = np.asarray(budgets, dtype=float)
    if active is None:
        active = list(range(len(units)))

    def mem(d):
        return units[d] * unit_mem + other_mem[d]

    oom = [d for d in active if mem(d) > budgets[d]]
    if not oom:
        return units
    free = [d for d in active if d not in oom and mem(d) < budgets[d]]
    if not free:
        return None

    next_active = [d for d in active if d not in oom]
    for o in oom:
        headroom_units = int(np.floor((budgets[o] - other_mem[o]) / unit_mem))
        headroom_units = max(headroom_units, 0)
        waiting_shift = units[o] - headroom_units  # overflowing workload
        if waiting_shift <= 0:
            continue
        vf = v[free]
        shares = vf / vf.sum() * waiting_shift
        moved = _largest_remainder_round(shares, waiting_shift)
        for f, mv in zip(free, moved):
            units[f] += int(mv)
        units[o] = headroom_units
    return memory_aware_balancing(units, unit_mem, v, budgets, other_mem, next_active)


def regularize_pad_spread(
    units: np.ndarray,
    capacities: Sequence[float],
    penalty: float,
) -> np.ndarray:
    """Trade straggler latency against pad spread (the ``max(units)`` term).

    Sweeps every candidate ``max(units)`` ceiling from the equal split up to
    the proportional split's straggler, waterfilling units proportional to
    capacity under the ceiling, and keeps the assignment minimizing

        cost = max_d(units_d / V_d) / t_balanced  +  penalty * pad_waste

    with ``pad_waste = D * max(units) / total - 1``.  ``penalty=0`` returns
    the input unchanged (the paper's pure Eq. 4/5 objective).
    """
    units = np.asarray(units).copy().astype(int)
    v = np.asarray(capacities, dtype=float)
    n = len(units)
    total = int(units.sum())
    if penalty <= 0 or n <= 1 or total == 0:
        return units
    t_balanced = total / v.sum()

    def cost(u: np.ndarray) -> float:
        waste = n * u.max() / total - 1.0
        return float(np.max(u / v)) / t_balanced + penalty * waste

    def capped(cap: int) -> Optional[np.ndarray]:
        """Capacity-proportional waterfill with every device <= cap."""
        if cap * n < total:
            return None
        out = np.zeros(n, int)
        active = list(range(n))
        rem = total
        while True:
            assign = balanced_partition(rem, v[active])
            over = [i for i, a in zip(active, assign) if a > cap]
            if not over:
                for i, a in zip(active, assign):
                    out[i] = a
                return out
            for i in over:
                out[i] = cap
                rem -= cap
            active = [i for i in active if i not in over]

    best, best_cost = units, cost(units)
    for cap in range(-(-total // n), int(units.max()) + 1):
        cand = capped(cap)
        if cand is None:
            continue
        c = cost(cand)
        if c < best_cost - 1e-12:
            best, best_cost = cand, c
    return best


def sequence_partition(
    seq_units: int,
    capacities: Sequence[float],
    links=None,
    *,
    unit_bytes: float = 1.0,
    unit_con_time: Optional[Sequence[float]] = None,
    rotations: int = 4,
) -> np.ndarray:
    """Per-device sequence tiles from compute capacity *and* link bandwidth.

    Minimizes ``max_d(tiles_d * con_d) + rotations * t_ring_exchange(...)``
    — the straggler connective block plus the per-layer ring rotations
    (4 collective⊗GEMM pairs, paper §III-D) — by greedy row moves from a
    capacity-proportional start.  Without links the capacity-proportional
    split is returned.  ``unit_bytes`` must be positive when links are given
    (a zero would make the cost constant).  ``unit_con_time`` defaults to a
    proxy that scales like the link-byte time and inversely with capacity.
    """
    v = np.asarray(capacities, dtype=float)
    tiles = _largest_remainder_round(v / v.sum() * seq_units, seq_units)
    if links is None or seq_units <= 0 or len(v) <= 1:
        return tiles
    if unit_bytes <= 0:
        raise ValueError(
            "unit_bytes must be positive when links are given — a zero "
            "byte weight makes the cost constant and silently returns the "
            "capacity-proportional split"
        )

    ring = costmodel.as_ring_links(links, len(v))
    if unit_con_time is None:
        bw = np.mean([l.bandwidth for l in ring])
        con = (unit_bytes / max(bw, 1e-30)) * (v.mean() / v)
    else:
        con = np.asarray(unit_con_time, dtype=float)

    def cost(t: np.ndarray) -> float:
        t_con = float(np.max(t * con))
        comm = costmodel.t_ring_exchange(t * unit_bytes, ring)
        return t_con + rotations * comm

    best = tiles.astype(int)
    best_cost = cost(best)
    n = len(best)
    step = max(1, seq_units // (4 * n))
    while True:
        improved = False
        for src in range(n):
            if best[src] < step:
                continue
            for dst in range(n):
                if dst == src:
                    continue
                cand = best.copy()
                cand[src] -= step
                cand[dst] += step
                c = cost(cand)
                if c < best_cost - 1e-15:
                    best, best_cost, improved = cand, c, True
        if not improved:
            if step == 1:
                break
            step = max(1, step // 2)
    return best


def plan(
    model: ModelProfile,
    devices: Sequence[DeviceProfile],
    links=None,
    *,
    seq_units: int = 0,
    unit_bytes: float = 1.0,
    unit_con_time: Optional[Sequence[float]] = None,
    pad_penalty: float = 0.0,
) -> Plan:
    """Full Algorithm 1 (+ the ragged-SP extension when ``links`` is given).

    ``pad_penalty`` post-passes the balanced head/column partitions through
    :func:`regularize_pad_spread` before memory-aware balancing.
    """
    v = [d.capacity for d in devices]
    budgets = [d.memory_budget for d in devices]
    n = len(devices)

    a = balanced_partition(model.num_heads, v)        # line 7
    b = balanced_partition(model.mlp_columns, v)      # line 8
    if pad_penalty > 0:
        a = regularize_pad_spread(a, v, pad_penalty)
        b = regularize_pad_spread(b, v, pad_penalty)
    if links is None:
        seq = np.full(n, 1.0 / n)                     # §III-C-2: equal SP split
    else:
        units = seq_units or 32 * n
        tiles = sequence_partition(
            units, v, links, unit_bytes=unit_bytes,
            unit_con_time=unit_con_time,
        )
        seq = tiles.astype(float) / units

    att_unit = model.num_layers * model.m_att / model.num_heads
    mlp_unit = model.num_layers * model.m_mlp / model.mlp_columns

    # line 21: rebalance MLP first (finer granularity), MHA memory fixed
    b2 = memory_aware_balancing(b, mlp_unit, v, budgets, other_mem=a * att_unit)
    if b2 is None:
        return Plan(a, b, seq, False, "MLP rebalancing infeasible")
    # line 22: rebalance MHA with the final MLP memory committed
    a2 = memory_aware_balancing(a, att_unit, v, budgets, other_mem=b2 * mlp_unit)
    if a2 is None:
        return Plan(a, b2, seq, False, "MHA rebalancing infeasible")

    if pad_penalty > 0:
        # memory balancing can re-raise max(units); re-regularize and keep
        # the result only if it still fits every budget
        a3 = regularize_pad_spread(a2, v, pad_penalty)
        b3 = regularize_pad_spread(b2, v, pad_penalty)
        if not np.any(a3 * att_unit + b3 * mlp_unit > np.asarray(budgets)):
            a2, b2 = a3, b3

    # lines 23-24: final feasibility check
    total = a2 * att_unit + b2 * mlp_unit
    if np.any(total > np.asarray(budgets)):
        return Plan(a2, b2, seq, False, "OOM persists after redistribution")
    return Plan(a2, b2, seq, True)


def block_latency(units: int, total_units: int, total_flops: float, capacity: float) -> float:
    """L(T, C_d, d): execution latency of a block shard on one device."""
    return (units / total_units) * total_flops / capacity


def plan_latency(
    plan_: Plan,
    model: ModelProfile,
    devices: Sequence[DeviceProfile],
    mha_flops: float,
    mlp_flops: float,
    con_time_full: float,
) -> float:
    """Eq. 4/5 objective: per-layer straggler latency under a plan
    (capacity normalized so total_flops / capacity = seconds)."""
    t_mha = max(
        block_latency(int(a), model.num_heads, mha_flops, d.capacity)
        for a, d in zip(plan_.mha, devices)
    )
    t_mlp = max(
        block_latency(int(b), model.mlp_columns, mlp_flops, d.capacity)
        for b, d in zip(plan_.mlp, devices)
    )
    t_con = con_time_full * float(np.max(plan_.seq))
    return t_mha + t_mlp + t_con
