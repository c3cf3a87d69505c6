"""Ring schedules: tile-granular compute/communication overlap (paper §III-D).

The GEMM adjacent to each collective is decomposed into row tiles and
pipelined over a D-step ring, each hop's transfer overlapping the previous
tile's GEMM.  The program is one object:

* ``TileSpec``     — one ring tile: owner, real rows (``valid``), and rows
  each hop ships (``bucket``).
* ``RingSchedule`` — the tiles in ring order, the common buffer size
  (``pad_tile``), the transport mode, double buffering, and the per-tile
  compute hook (``gemm``).

The D devices are the shards of a :class:`LocalRing`: one process holds
every device's tensors (a list of D tensors per quantity) and runs each
device's step in turn.  A hop is an explicit device copy of the held tile
to the next device; under bucketed transport a hop ships row segments and
a receiver not named in a segment's pairs gets exact zeros, the
partial-permutation rule of the reference's ``ppermute``.  So the shard
compute is real and the wire is not timed.

Ragged sequence tiles ride the ring padded to ``pad_tile`` rows; at each
step the pad rows of the held tile are masked out of the GEMM (or the
valid-length kernel skips them), so pad rows contribute exactly zero.
Padded and bucketed transport, with or without double buffering, give
bitwise-equal results: the dataflow and summation order are unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

# per-tile GEMM hook: (device, x_tile (B,S,d), w (d,F), valid_rows | None)
# -> (B,S,F) with pad rows (rows >= valid_rows) exactly zero
TileGemm = Callable[..., torch.Tensor]

#: supported wire formats for ragged tiles
RING_TRANSPORTS = ("padded", "bucketed")

#: default bucket granularity: tiles round up to pad_tile/4 row multiples
BUCKETS_PER_TILE = 4


def _perm(d: int, shift: int = 1):
    return [(i, (i + shift) % d) for i in range(d)]


class LocalRing:
    """D logical ring devices held as D shards in one process.

    Every per-device quantity is a list of D tensors on one card (or the
    CPU).  ``permute`` is the ring hop and ``psum`` the all-reduce; both
    are explicit, so the same program later maps onto real point-to-point
    transport.
    """

    def __init__(self, num_devices: int):
        if num_devices < 1:
            raise ValueError(f"a ring needs >= 1 device, got {num_devices}")
        self.num_devices = num_devices

    def permute(self, vals: Sequence[torch.Tensor], pairs) -> List[torch.Tensor]:
        """Send ``vals[src]`` to ``dst`` for each ``(src, dst)`` pair (a
        copy of the held tile).  Devices not named as a destination receive
        exact zeros."""
        out: List[Optional[torch.Tensor]] = [None] * self.num_devices
        for src, dst in pairs:
            out[dst] = vals[src].clone()
        return [o if o is not None else torch.zeros_like(v)
                for o, v in zip(out, vals)]

    def psum(self, vals: Sequence[torch.Tensor]) -> torch.Tensor:
        """Sum over the D shards (the all-reduce of the decode step)."""
        acc = vals[0]
        for v in vals[1:]:
            acc = acc + v
        return acc


@dataclasses.dataclass(frozen=True)
class TileSpec:
    """One ring tile: its owner, real rows, and on-wire rows
    (``valid <= bucket <= pad_tile``)."""

    owner: int
    valid: int
    bucket: int


@dataclasses.dataclass(frozen=True)
class RingSchedule:
    """The per-step program of a D-device ring (see module docstring)."""

    tiles: Tuple[TileSpec, ...]
    pad_tile: int
    transport: str = "padded"
    double_buffer: bool = False
    gemm: Optional[TileGemm] = None

    def __post_init__(self):
        object.__setattr__(self, "tiles", tuple(self.tiles))
        if not self.tiles:
            raise ValueError("RingSchedule needs at least one tile")
        if self.pad_tile < 1:
            raise ValueError(f"pad_tile must be >= 1, got {self.pad_tile}")
        if self.transport not in RING_TRANSPORTS:
            raise ValueError(
                f"unknown ring transport {self.transport!r}; "
                f"expected one of {RING_TRANSPORTS}"
            )
        for i, t in enumerate(self.tiles):
            if t.owner != i:
                raise ValueError(
                    f"tiles must be in ring order: tiles[{i}].owner == {t.owner}"
                )
            if not (0 <= t.valid <= t.bucket <= self.pad_tile):
                raise ValueError(
                    f"tile {i}: need 0 <= valid <= bucket <= pad_tile, got "
                    f"valid={t.valid} bucket={t.bucket} pad_tile={self.pad_tile}"
                )

    # --- constructors ---------------------------------------------------------

    @classmethod
    def ragged(cls, tiles: Sequence[int], *, pad_tile: Optional[int] = None,
               transport: str = "padded", bucket_grain: Optional[int] = None,
               double_buffer: bool = False,
               gemm: Optional[TileGemm] = None) -> "RingSchedule":
        """Schedule for per-device ``tiles`` valid row counts, in ring order.

        Under bucketed transport each tile's wire size rounds up to a
        multiple of ``bucket_grain`` (default ``ceil(pad_tile /
        BUCKETS_PER_TILE)``), clipped to ``pad_tile``; zero tiles ship
        nothing.
        """
        valid = [int(t) for t in tiles]
        if pad_tile is None:
            pad_tile = max(valid) if valid else 0
        pad_tile = int(pad_tile)
        if transport == "bucketed":
            grain = int(bucket_grain) if bucket_grain else max(
                1, -(-pad_tile // BUCKETS_PER_TILE))
            buckets = [min(pad_tile, -(-v // grain) * grain) for v in valid]
        else:
            buckets = [pad_tile] * len(valid)
        specs = tuple(
            TileSpec(owner=i, valid=v, bucket=b)
            for i, (v, b) in enumerate(zip(valid, buckets))
        )
        return cls(specs, pad_tile=pad_tile, transport=transport,
                   double_buffer=double_buffer, gemm=gemm)

    @classmethod
    def dense(cls, num_devices: int, tile_size: int, *,
              transport: str = "padded", double_buffer: bool = False,
              gemm: Optional[TileGemm] = None) -> "RingSchedule":
        """Equal fully-valid tiles — the classic even-split ring."""
        return cls.ragged([tile_size] * num_devices, pad_tile=tile_size,
                          transport=transport, double_buffer=double_buffer,
                          gemm=gemm)

    def with_gemm(self, gemm: Optional[TileGemm]) -> "RingSchedule":
        """The same wire program with a different per-tile compute hook."""
        return dataclasses.replace(self, gemm=gemm)

    # --- static geometry ------------------------------------------------------

    @property
    def num_devices(self) -> int:
        return len(self.tiles)

    @property
    def valid_sizes(self) -> np.ndarray:
        return np.asarray([t.valid for t in self.tiles], int)

    @property
    def buckets(self) -> np.ndarray:
        return np.asarray([t.bucket for t in self.tiles], int)

    @property
    def is_masked(self) -> bool:
        """Whether any tile carries pad rows (per-step masking needed)."""
        return bool((self.valid_sizes < self.pad_tile).any())

    @property
    def is_bucketed(self) -> bool:
        """Whether any hop ships fewer than ``pad_tile`` rows."""
        return self.transport == "bucketed" and bool(
            (self.buckets < self.pad_tile).any())

    @property
    def segment_bounds(self) -> Tuple[int, ...]:
        """Row boundaries of the per-hop wire segments: (0, b_1, .., b_max)."""
        return (0, *sorted({t.bucket for t in self.tiles if t.bucket > 0}))

    def source(self, device: int, step: int) -> int:
        """Owner of the tile ``device`` holds at ring step ``step``."""
        return (device - step) % self.num_devices

    def buffer_slot(self, step: int) -> int:
        """Which of the two tile buffers step ``step`` computes from."""
        return step % 2 if self.double_buffer else 0

    # --- wire accounting (what the hops actually ship) ------------------------

    def hop_rows(self, hop: int) -> np.ndarray:
        """Rows device ``i`` ships on hop ``hop`` (it holds tile source(i, hop))."""
        d = self.num_devices
        return np.asarray(
            [self.tiles[(i - hop) % d].bucket for i in range(d)], int)

    def total_wire_rows(self) -> int:
        """Tile rows shipped across one full rotation (d-1 hops, all links)."""
        return (self.num_devices - 1) * int(self.buckets.sum())

    def padded_wire_rows(self) -> int:
        """What one rotation would ship under padded transport."""
        return (self.num_devices - 1) * self.num_devices * self.pad_tile

    def wire_fraction(self) -> float:
        """Shipped rows as a fraction of the padded-transport rotation."""
        padded = self.padded_wire_rows()
        return self.total_wire_rows() / padded if padded else 1.0

    # --- the hop itself -------------------------------------------------------

    def ship(self, tiles: Sequence[torch.Tensor], ring: LocalRing,
             hop: int) -> List[torch.Tensor]:
        """One ring hop (device i -> i+1) of the currently held tiles.

        Padded transport copies each whole tile.  Bucketed transport ships
        the row segments between consecutive bucket boundaries; a segment
        names only the devices whose held tile reaches that boundary, so
        receivers of an omitted segment get exact zeros (their pad rows).
        """
        d = self.num_devices
        if not self.is_bucketed:
            return ring.permute(tiles, _perm(d))
        buckets = self.buckets
        bounds = self.segment_bounds
        parts: List[List[torch.Tensor]] = [[] for _ in range(d)]
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            pairs = [(i, (i + 1) % d) for i in range(d)
                     if buckets[(i - hop) % d] >= hi]
            moved = ring.permute([t[:, lo:hi] for t in tiles], pairs)
            for i in range(d):
                parts[i].append(moved[i])
        if bounds[-1] < self.pad_tile:
            for i, t in enumerate(tiles):
                shape = list(t.shape)
                shape[1] = self.pad_tile - bounds[-1]
                parts[i].append(t.new_zeros(shape))
        return [p[0] if len(p) == 1 else torch.cat(p, dim=1) for p in parts]


def _masked_rows(tile: torch.Tensor, valid: int) -> torch.Tensor:
    """Zero the rows ``>= valid`` of a (B, S, F) tile (a select, so garbage
    in pad rows cannot leak even when it is not finite)."""
    keep = torch.arange(tile.shape[1], device=tile.device) < valid
    return torch.where(keep[None, :, None], tile, torch.zeros((), dtype=tile.dtype,
                                                              device=tile.device))


def _resolve_allgather(schedule: Optional[RingSchedule], *, d: int,
                       s_loc: int) -> RingSchedule:
    if schedule is None:
        return RingSchedule.dense(d, s_loc)
    if schedule.num_devices != d:
        raise ValueError(
            f"schedule covers {schedule.num_devices} devices "
            f"but the ring has {d}"
        )
    if schedule.pad_tile != s_loc:
        raise ValueError(
            f"local sequence tile is {s_loc} rows but the schedule's "
            f"pad_tile={schedule.pad_tile}; the ring AllGather moves "
            "whole local tiles"
        )
    return schedule


def _resolve_scatter(schedule: Optional[RingSchedule], *, d: int,
                     s: int) -> RingSchedule:
    if schedule is None:
        if s % d:
            raise ValueError(
                f"sequence {s} does not divide over a ring of {d} devices; "
                "pass a schedule, or run a ragged layout "
                "(ExecPlan.ring_schedule / RingSchedule.ragged)"
            )
        return RingSchedule.dense(d, s // d)
    if schedule.num_devices != d:
        raise ValueError(
            f"schedule covers {schedule.num_devices} devices "
            f"but the ring has {d}"
        )
    if d * schedule.pad_tile != s:
        raise ValueError(
            f"tile_size={schedule.pad_tile} x {d} devices != sequence "
            f"{s}; the ring ReduceScatter consumes exactly one tile per "
            "device per step"
        )
    return schedule


def _tile_gemm(sched: RingSchedule, dev: int, tile, w, valid: Optional[int]):
    if sched.gemm is not None:
        # valid-length kernel: masks pad rows itself and skips pad blocks
        return sched.gemm(dev, tile, w, valid)
    if valid is not None:
        tile = _masked_rows(tile, valid)
    return torch.matmul(tile, w)


def ring_allgather_matmul(xs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
                          ring: LocalRing, *,
                          schedule: Optional[RingSchedule] = None):
    """Overlapped ``all_gather(x, seq) @ w_local`` on every ring device.

    xs[i]: (B, S_loc, d) — device i's sequence tile (paper's H_i)
    ws[i]: (d, F_loc)    — device i's column shard (paper's W_i^D)
    returns: per device (B, D*pad_tile, F_loc) — full-sequence activation
             (padded layout when ragged), local columns.

    Step r computes the GEMM for the tile received r hops ago while the
    next tile is in flight; the final step does no communication.
    """
    d = ring.num_devices
    b, s_loc, _ = xs[0].shape
    sched = _resolve_allgather(schedule, d=d, s_loc=s_loc)
    vs = sched.valid_sizes if sched.is_masked else None
    ts = sched.pad_tile
    outs = [xs[i].new_empty((b, d * ts, ws[i].shape[1])) for i in range(d)]
    tiles = list(xs)
    for r in range(d):
        nxt = None
        if sched.double_buffer and r != d - 1:
            # issue hop r before the GEMMs that free its buffer
            nxt = sched.ship(tiles, ring, r)
        for i in range(d):
            src = sched.source(i, r)  # owner of the tile device i holds
            vrows = None if vs is None else int(vs[src])
            outs[i][:, src * ts:(src + 1) * ts] = _tile_gemm(
                sched, i, tiles[i], ws[i], vrows)
        if r != d - 1:
            tiles = nxt if nxt is not None else sched.ship(tiles, ring, r)
    return outs


def matmul_ring_reducescatter(hs: Sequence[torch.Tensor],
                              ws: Sequence[torch.Tensor], ring: LocalRing, *,
                              schedule: Optional[RingSchedule] = None):
    """Overlapped ``psum_scatter(h_local @ w_local, seq)`` over the ring.

    hs[i]: (B, S, F_loc) — full sequence, device i's column shard (E_i)
    ws[i]: (F_loc, d)    — row shard of the second GEMM (W_i^E)
    returns: per device (B, pad_tile, d) — its tile of the summed output.

    At step r device i GEMMs its tile (i - r + D - 1) mod D and adds the
    partial sum arriving from its predecessor, which processed the same
    tile one step earlier.  After D steps device i owns the reduced tile i.
    """
    d = ring.num_devices
    b, s, _ = hs[0].shape
    sched = _resolve_scatter(schedule, d=d, s=s)
    vs = sched.valid_sizes if sched.is_masked else None
    ts = sched.pad_tile

    acc = None
    for r in range(d):
        inc = None
        if acc is not None and sched.double_buffer:
            # the partial-accumulator hop is issued before this step's GEMMs
            inc = sched.ship(acc, ring, r)
        parts = []
        for i in range(d):
            t = (i - r + d - 1) % d  # tile index device i processes this step
            tile = hs[i][:, t * ts:(t + 1) * ts]
            parts.append(_tile_gemm(sched, i, tile, ws[i],
                                    None if vs is None else int(vs[t])))
        if acc is None:
            acc = parts
        else:
            if inc is None:
                inc = sched.ship(acc, ring, r)
            acc = [p + c for p, c in zip(parts, inc)]
    return acc


# --- unoverlapped references (the paper's "sync" baseline schedule) -----------

def _global_valid_mask(vs: np.ndarray, tile_size: int) -> np.ndarray:
    """(D*tile_size,) bool: valid rows of the concatenated padded layout."""
    return np.concatenate([np.arange(tile_size) < v for v in vs])


def _mask_global(x: torch.Tensor, vs: np.ndarray, tile_size: int):
    keep = torch.as_tensor(_global_valid_mask(vs, tile_size), device=x.device)
    return torch.where(keep[None, :, None], x,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def sync_allgather_matmul(xs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
                          ring: LocalRing, *,
                          schedule: Optional[RingSchedule] = None):
    """Unoverlapped oracle for ``ring_allgather_matmul`` (same schedule arg).

    Transport mode and double buffering are ring-only concerns and are
    ignored here; only the schedule's valid row counts and gemm hook apply.
    """
    d = ring.num_devices
    sched = _resolve_allgather(schedule, d=d, s_loc=xs[0].shape[1])
    xg = torch.cat(list(xs), dim=1)
    if sched.is_masked:
        # the gathered sequence mixes per-tile valid counts, which the
        # prefix-valid kernel cannot express: mask rows here either way
        xg = _mask_global(xg, sched.valid_sizes, sched.pad_tile)
    return [_tile_gemm(sched, i, xg, ws[i], None) for i in range(d)]


def sync_matmul_reducescatter(hs: Sequence[torch.Tensor],
                              ws: Sequence[torch.Tensor], ring: LocalRing, *,
                              schedule: Optional[RingSchedule] = None):
    """Unoverlapped oracle for ``matmul_ring_reducescatter``."""
    d = ring.num_devices
    sched = _resolve_scatter(schedule, d=d, s=hs[0].shape[1])
    outs = []
    for i in range(d):
        h = hs[i]
        if sched.is_masked:
            h = _mask_global(h, sched.valid_sizes, sched.pad_tile)
        outs.append(_tile_gemm(sched, i, h, ws[i], None))
    total = ring.psum(outs)
    ts = sched.pad_tile
    return [total[:, i * ts:(i + 1) * ts] for i in range(d)]
