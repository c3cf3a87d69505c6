"""Ring schedules: tile-granular compute/communication overlap (paper §III-D).

The GEMM adjacent to each collective is decomposed into row tiles and
pipelined over a D-step ring, each hop's transfer overlapping the previous
tile's GEMM.  The program is one object:

* ``TileSpec``     — one ring tile: owner, real rows (``valid``), and rows
  each hop ships (``bucket``).
* ``RingSchedule`` — the tiles in ring order, the common buffer size
  (``pad_tile``), the transport mode, double buffering, and the per-tile
  compute hook (``gemm``).

The D devices live on one of two rings with one interface.  On a
:class:`LocalRing` one process holds every device's tensors (a list of D
tensors per quantity) and runs each device's step in turn; a hop is a
device copy, so the shard compute is real and the wire is not timed.  On a
:class:`ProcessRing` each of D processes (``torch.distributed`` ranks) holds
its own device's tensors (lists of one) and a hop is a point-to-point
transfer over the process group.  ``ring.devices`` names the devices a
process holds; every per-device list is in that order.  Under bucketed
transport a hop ships row segments and a receiver not named in a
segment's pairs gets exact zeros, the partial-permutation rule of the
reference's ``ppermute``.

Ragged sequence tiles ride the ring padded to ``pad_tile`` rows; at each
step the pad rows of the held tile are masked out of the GEMM (or the
valid-length kernel skips them), so pad rows contribute exactly zero.
Padded and bucketed transport, with or without double buffering, give
bitwise-equal results: the dataflow and summation order are unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

# per-tile GEMM hook: (j, x_tile (B,S,d), w (d,F), valid_rows | None) ->
# (B,S,F) with pad rows (rows >= valid_rows) exactly zero; j indexes the
# devices this process holds (``ring.devices[j]``)
TileGemm = Callable[..., torch.Tensor]

#: supported wire formats for ragged tiles
RING_TRANSPORTS = ("padded", "bucketed")

#: default bucket granularity: tiles round up to pad_tile/4 row multiples
BUCKETS_PER_TILE = 4


def _perm(d: int, shift: int = 1):
    return [(i, (i + shift) % d) for i in range(d)]


def _sum_in_order(vals: Sequence[torch.Tensor]) -> torch.Tensor:
    acc = vals[0]
    for v in vals[1:]:
        acc = acc + v
    return acc


class _Done:
    """A hop that completed when it was posted (``permute_start``)."""

    def __init__(self, vals: List[torch.Tensor]):
        self._vals = vals

    def wait(self) -> List[torch.Tensor]:
        return self._vals


class LocalRing:
    """D logical ring devices held as D shards in one process.

    Every per-device quantity is a list of D tensors on one card (or the
    CPU), one per device of ``devices`` (all of them).  ``permute`` is the
    ring hop, ``psum`` the all-reduce and ``all_gather`` the gather; the
    same program runs on :class:`ProcessRing`, one process per device.
    With one device there is no hop: the ring primitives run their single
    step and ship nothing.
    """

    transport = "local"

    def __init__(self, num_devices: int):
        if num_devices < 1:
            raise ValueError(f"a ring needs >= 1 device, got {num_devices}")
        self.num_devices = num_devices
        self.devices = tuple(range(num_devices))

    def permute(self, vals: Sequence[torch.Tensor], pairs) -> List[torch.Tensor]:
        """Send ``vals[src]`` to ``dst`` for each ``(src, dst)`` pair (a
        copy of the held tile).  Devices not named as a destination receive
        exact zeros."""
        out: List[Optional[torch.Tensor]] = [None] * self.num_devices
        for src, dst in pairs:
            out[dst] = vals[src].clone()
        return [o if o is not None else torch.zeros_like(v)
                for o, v in zip(out, vals)]

    def permute_start(self, vals: Sequence[torch.Tensor], pairs,
                      tag: int = 0) -> _Done:
        """``permute`` as a posted hop (``.wait()`` gives its result); a
        copy completes when it is posted."""
        return _Done(self.permute(vals, pairs))

    def psum(self, vals: Sequence[torch.Tensor]) -> torch.Tensor:
        """Sum over the D shards (the all-reduce of the decode step)."""
        return _sum_in_order(vals)

    def all_gather(self, vals: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        """The D shards joined along ``dim`` in device order (what every
        device holds after the all-gather of the SP baseline)."""
        return torch.cat(list(vals), dim=dim)

    def agree(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """The value every device takes for a host decision (sampled token
        ids, a draft's proposals) made on device ``src``: one process
        decides alone, so ``t`` itself."""
        return t


class _Posted:
    """The point-to-point operations of one :class:`ProcessRing` hop, in
    flight; ``wait`` completes them and gives the received tile."""

    def __init__(self, works, finish: Callable[[], List[torch.Tensor]],
                 keep: Sequence[torch.Tensor]):
        self._works = works
        self._finish = finish
        self._keep = keep  # send buffers stay alive until the sends complete

    def wait(self) -> List[torch.Tensor]:
        for w in self._works:
            w.wait()
        self._keep = ()
        return self._finish()


class ProcessRing:
    """D ring devices, one per process: this process is rank ``rank`` of
    ``group`` (the default group when None) and holds device ``rank``.

    The interface is :class:`LocalRing`'s with lists of one tensor (this
    device's).  ``permute`` posts this rank's part of the hop (a send where
    it is a source in ``pairs``, a receive where it is a destination) with
    ``dist.batch_isend_irecv``; a rank named in no pair posts nothing and
    gets exact zeros.  Every rank calls the ring primitives in the same
    order with the same arguments, so the operations the ranks post always
    match.  ``psum`` is an all-gather followed by a sum in device order,
    as ``LocalRing.psum`` adds, so every rank holds the same bits and a
    run equals a ``LocalRing`` run bit for bit.

    The transport is gloo.  CUDA tensors are staged through pinned host
    buffers here (route "host-staged"), as the zoo mesh's collectives are
    by :func:`stage_mesh_collectives`; CPU tensors go as they are
    ("direct").  ``hops``, ``hop_bytes`` and ``routes`` count the
    hops this rank took part in, the bytes it sent and each route's hops.
    """

    transport = "gloo"

    def __init__(self, rank: int, num_devices: int, group=None):
        if num_devices < 1:
            raise ValueError(f"a ring needs >= 1 device, got {num_devices}")
        size = dist.get_world_size(group)
        if size != num_devices:
            raise ValueError(f"the process group has {size} ranks but the ring "
                             f"needs {num_devices}")
        if not 0 <= rank < num_devices:
            raise ValueError(f"rank {rank} is outside a ring of {num_devices}")
        self.group = group
        self.rank = rank
        self.num_devices = num_devices
        self.devices = (rank,)
        self.hops = 0
        self.hop_bytes = 0
        self.routes = {}  # route -> hops that took it

    def _peer(self, device: int) -> int:
        return device if self.group is None else dist.get_global_rank(self.group, device)

    @staticmethod
    def _to_host(t: torch.Tensor) -> torch.Tensor:
        """A contiguous host copy the transport may read (CPU tensors are
        sent from their own memory)."""
        if not t.is_cuda:
            return t.contiguous()
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        return buf

    @staticmethod
    def _host_like(t: torch.Tensor) -> torch.Tensor:
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)

    @staticmethod
    def _to_device(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        # the pinned buffer is not reused until this copy has run: the
        # caching host allocator records the copy's stream on it
        return buf.to(like.device, non_blocking=True) if like.is_cuda else buf

    def permute_start(self, vals: Sequence[torch.Tensor], pairs,
                      tag: int = 0) -> Union[_Posted, _Done]:
        """Post this rank's part of the hop ``pairs``; ``.wait()`` gives
        the received tile (exact zeros when nothing is received).
        ``tag`` tells apart the hops posted together (bucketed segments)."""
        (v,) = vals
        me = self.rank
        dst = [d for s, d in pairs if s == me]
        src = [s for s, d in pairs if d == me]
        if dst == [me]:  # a one-device ring keeps its own tile
            return _Done([v.clone()])
        ops, sends = [], []
        if dst:
            host = self._to_host(v)
            sends.append(host)
            ops.append(dist.P2POp(dist.isend, host, self._peer(dst[0]), self.group, tag))
            self.hop_bytes += host.numel() * host.element_size()
        recv = None
        if src:
            recv = self._host_like(v)
            ops.append(dist.P2POp(dist.irecv, recv, self._peer(src[0]), self.group, tag))
        if not ops:
            return _Done([torch.zeros_like(v)])
        self.hops += 1
        route = "host-staged" if v.is_cuda else "direct"
        self.routes[route] = self.routes.get(route, 0) + 1
        works = dist.batch_isend_irecv(ops)

        def finish():
            return [torch.zeros_like(v) if recv is None else self._to_device(recv, v)]

        return _Posted(works, finish, sends)

    def permute(self, vals: Sequence[torch.Tensor], pairs) -> List[torch.Tensor]:
        return self.permute_start(vals, pairs).wait()

    def _gather(self, v: torch.Tensor) -> List[torch.Tensor]:
        """Every device's tensor, in device order, on ``v``'s device."""
        host = self._to_host(v)
        parts = [self._host_like(v) for _ in range(self.num_devices)]
        dist.all_gather(parts, host, group=self.group)
        return [self._to_device(p, v) for p in parts]

    def psum(self, vals: Sequence[torch.Tensor]) -> torch.Tensor:
        (v,) = vals
        return _sum_in_order(self._gather(v))

    def all_gather(self, vals: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        (v,) = vals
        return torch.cat(self._gather(v), dim=dim)

    def agree(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank (token ids sampled on each
        rank, or the proposals of a draft that only rank ``src`` holds):
        every rank posts the broadcast with a ``t`` of the same shape and
        dtype, and the host state of every rank moves on from the same
        values."""
        host = self._to_host(t).clone()
        dist.broadcast(host, src=self._peer(src), group=self.group)
        return self._to_device(host, t)


#: either ring: the HMP program is written once against this interface
Ring = Union[LocalRing, ProcessRing]


#: the collectives a ``DTensor`` mesh issues, as (op namespace, op), each
#: staged through pinned host memory on a gloo group by
#: :func:`stage_mesh_collectives`
MESH_COLLECTIVES = (("_c10d_functional", "all_gather_into_tensor"),
                    ("_c10d_functional", "reduce_scatter_tensor"),
                    ("_c10d_functional", "all_reduce"),
                    ("_c10d_functional", "all_to_all_single"),
                    ("_c10d_functional", "broadcast"),
                    ("_dtensor", "shard_dim_alltoall"))
_STAGING: List = []  # the dispatcher registrations, made once per process

#: {collective: [staged calls, bytes this process sent]} since the process began
MESH_STAGED: dict = {}


def stage_mesh_collectives() -> None:
    """Route the collectives that ``DTensor`` issues on CUDA tensors over a
    gloo group through pinned host buffers, as ``ProcessRing`` stages its
    hops: gloo's all-gather of a CUDA tensor kills its process.  A CUDA
    kernel is registered for each of :data:`MESH_COLLECTIVES`; on a gloo
    group it copies the input to pinned host memory, runs the collective
    there and copies the result back, counting the call in
    :data:`MESH_STAGED`; on a group of any other backend it runs torch's own
    kernel.  ``launch/ranks.init`` calls it when a rank joins its gloo group
    on CUDA.  Once per process."""
    if _STAGING:
        return
    for ns in sorted({ns for ns, _ in MESH_COLLECTIVES}):
        lib = torch.library.Library(ns, "IMPL")
        for space, name in MESH_COLLECTIVES:
            if space == ns:
                lib.impl(name, _staged_collective(ns, name), "CUDA")
        _STAGING.append(lib)


def mesh_collectives_staged() -> bool:
    return bool(_STAGING)


def _staged_collective(ns: str, name: str):
    """The staged kernel of one collective (the group's name is its last
    argument), or torch's own where the group is not gloo."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    op = getattr(getattr(torch.ops, ns), name).default

    def run(t: torch.Tensor, *args):
        group = args[-1]
        if isinstance(group, str):
            group = _resolve_process_group(group)
        if dist.get_backend(group) != "gloo":
            return op._op_dk(torch._C.DispatchKey.CompositeExplicitAutograd, t, *args)
        host = ProcessRing._to_host(t)
        out = torch.ops._c10d_functional.wait_tensor(op(host, *args))
        calls = MESH_STAGED.setdefault(name, [0, 0])
        calls[0] += 1
        calls[1] += host.numel() * host.element_size()
        return ProcessRing._to_device(out, t)

    return run


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

    def ship_start(self, tiles: Sequence[torch.Tensor], ring: "Ring", hop: int):
        """Post one ring hop (device i -> i+1) of the currently held tiles;
        ``.wait()`` gives the received tiles.

        Padded transport sends each whole tile.  Bucketed transport ships
        the row segments between consecutive bucket boundaries, all posted
        together; a segment names only the devices whose held tile reaches
        that boundary, so receivers of an omitted segment get exact zeros
        (their pad rows).
        """
        d = self.num_devices
        if not self.is_bucketed:
            return ring.permute_start(tiles, _perm(d))
        buckets = self.buckets
        bounds = self.segment_bounds
        posted = []
        for seg, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
            pairs = [(i, (i + 1) % d) for i in range(d)
                     if buckets[(i - hop) % d] >= hi]
            posted.append(ring.permute_start([t[:, lo:hi] for t in tiles], pairs,
                                             tag=seg))
        return _Segments(posted, tiles, self.pad_tile - bounds[-1])

    def ship(self, tiles: Sequence[torch.Tensor], ring: "Ring",
             hop: int) -> List[torch.Tensor]:
        """One ring hop, posted and completed (``ship_start``)."""
        return self.ship_start(tiles, ring, hop).wait()


class _Segments:
    """The bucketed segments of one hop in flight; ``wait`` joins each
    device's received segments and its zero tail past the last bucket."""

    def __init__(self, posted, tiles: Sequence[torch.Tensor], tail: int):
        self._posted = posted
        self._tiles = tiles
        self._tail = tail

    def wait(self) -> List[torch.Tensor]:
        moved = [p.wait() for p in self._posted]
        out = []
        for j, t in enumerate(self._tiles):
            parts = [m[j] for m in moved]
            if self._tail > 0:
                shape = list(t.shape)
                shape[1] = self._tail
                parts.append(t.new_zeros(shape))
            out.append(parts[0] if len(parts) == 1 else torch.cat(parts, dim=1))
        return out


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


def _tile_gemm(sched: RingSchedule, j: int, tile, w, valid: Optional[int]):
    if sched.gemm is not None:
        # valid-length kernel: masks pad rows itself and skips pad blocks
        return sched.gemm(j, tile, w, valid)
    if valid is not None:
        tile = _masked_rows(tile, valid)
    return torch.matmul(tile, w)


def ring_allgather_matmul(xs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
                          ring: Ring, *,
                          schedule: Optional[RingSchedule] = None):
    """Overlapped ``all_gather(x, seq) @ w_local`` on every ring device.

    xs[j]: (B, S_loc, d) — the sequence tile of device i = ring.devices[j]
             (paper's H_i)
    ws[j]: (d, F_loc)    — device i's column shard (paper's W_i^D)
    returns: per held device (B, D*pad_tile, F_loc) — full-sequence
             activation (padded layout when ragged), local columns.

    Step r computes the GEMM for the tile received r hops ago.  Under
    double buffering the next hop is posted before the step's GEMMs and
    waited on after them, so it is in flight while they run; the final
    step does no communication.
    """
    d = ring.num_devices
    b, s_loc, _ = xs[0].shape
    sched = _resolve_allgather(schedule, d=d, s_loc=s_loc)
    vs = sched.valid_sizes if sched.is_masked else None
    ts = sched.pad_tile
    outs = [x.new_empty((b, d * ts, w.shape[1])) for x, w in zip(xs, ws)]
    tiles = list(xs)
    for r in range(d):
        hop = None
        if sched.double_buffer and r != d - 1:
            # issue hop r before the GEMMs that free its buffer
            hop = sched.ship_start(tiles, ring, r)
        for j, i in enumerate(ring.devices):
            src = sched.source(i, r)  # owner of the tile device i holds
            vrows = None if vs is None else int(vs[src])
            outs[j][:, src * ts:(src + 1) * ts] = _tile_gemm(
                sched, j, tiles[j], ws[j], vrows)
        if r != d - 1:
            tiles = (hop if hop is not None else sched.ship_start(tiles, ring, r)).wait()
    return outs


def matmul_ring_reducescatter(hs: Sequence[torch.Tensor],
                              ws: Sequence[torch.Tensor], ring: Ring, *,
                              schedule: Optional[RingSchedule] = None):
    """Overlapped ``psum_scatter(h_local @ w_local, seq)`` over the ring.

    hs[j]: (B, S, F_loc) — full sequence, the column shard (E_i) of
             device i = ring.devices[j]
    ws[j]: (F_loc, d)    — row shard of the second GEMM (W_i^E)
    returns: per held device (B, pad_tile, d) — its tile of the summed
             output.

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
        hop = None
        if acc is not None and sched.double_buffer:
            # the partial-accumulator hop is issued before this step's GEMMs
            hop = sched.ship_start(acc, ring, r)
        parts = []
        for j, i in enumerate(ring.devices):
            t = (i - r + d - 1) % d  # tile index device i processes this step
            tile = hs[j][:, t * ts:(t + 1) * ts]
            parts.append(_tile_gemm(sched, j, tile, ws[j],
                                    None if vs is None else int(vs[t])))
        if acc is None:
            acc = parts
        else:
            inc = (hop if hop is not None else sched.ship_start(acc, ring, r)).wait()
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
                          ring: Ring, *,
                          schedule: Optional[RingSchedule] = None):
    """Unoverlapped oracle for ``ring_allgather_matmul`` (same schedule arg).

    Transport mode and double buffering are ring-only concerns and are
    ignored here; only the schedule's valid row counts and gemm hook apply.
    """
    d = ring.num_devices
    sched = _resolve_allgather(schedule, d=d, s_loc=xs[0].shape[1])
    xg = ring.all_gather(xs, dim=1)
    if sched.is_masked:
        # the gathered sequence mixes per-tile valid counts, which the
        # prefix-valid kernel cannot express: mask rows here either way
        xg = _mask_global(xg, sched.valid_sizes, sched.pad_tile)
    return [_tile_gemm(sched, j, xg, w, None) for j, w in enumerate(ws)]


def sync_matmul_reducescatter(hs: Sequence[torch.Tensor],
                              ws: Sequence[torch.Tensor], ring: Ring, *,
                              schedule: Optional[RingSchedule] = None):
    """Unoverlapped oracle for ``matmul_ring_reducescatter``."""
    d = ring.num_devices
    sched = _resolve_scatter(schedule, d=d, s=hs[0].shape[1])
    outs = []
    for j, (h, w) in enumerate(zip(hs, ws)):
        if sched.is_masked:
            h = _mask_global(h, sched.valid_sizes, sched.pad_tile)
        outs.append(_tile_gemm(sched, j, h, w, None))
    total = ring.psum(outs)
    ts = sched.pad_tile
    return [total[:, i * ts:(i + 1) * ts] for i in ring.devices]
