"""Tiled GEMMs: the dense blocked GEMM and the valid-length GEMM of every
ring tile.

:func:`tiled_gemm` computes a dense ``(M, K) @ (K, N)`` with an fp32
accumulator, in the operands' dtype.  It keeps the reference's contract
(block sizes clipped to their axis must divide it), but the block sizes
only decide which shapes are accepted: the CUDA kernel of
``csrc/tiled_gemm.cu`` picks its own tiles.  It has two paths, chosen by
:func:`dense_path` from the dtype and the operands' alignment before the
launch and counted in ``tiled_gemm.paths``: ``"wgmma"`` (bf16/fp16 on the
tensor cores, operands staged by TMA) and ``"simt"`` (fp32, or operands
TMA cannot describe, on the CUDA cores).  On a CPU tensor it runs
:func:`tiled_gemm_plain`.  It replaces the TPU kernel
``src/repro/kernels/tiled_gemm.py:tiled_gemm``; as there, no serving path
calls it (its entry point is ``ops.tiled_gemm``).

:func:`tiled_gemm_valid` computes ``(M, K) @ (K, N)`` with an fp32
accumulator where only a valid prefix of each ``seg_m``-row M segment, of
each ``seg_n``-column N segment, and of the contraction is real; pad
outputs are exactly zero whatever the pad regions of the operands hold,
and tiles wholly in the padding issue no work.  On a CUDA tensor it
launches the hand-written kernel of ``csrc/tiled_gemm_valid.cu`` on the
grid :func:`plan_valid_gemm` lays out (short segments packed into one
tile, the contraction split over blocks); fp16 and bf16 run on the tensor
cores (path ``"mma"``), fp32 on the CUDA cores (path ``"fma"``), counted in
``tiled_gemm_valid.paths``.  On a CPU tensor it runs
:func:`tiled_gemm_valid_plain`, the same function in plain PyTorch.  It
replaces the TPU kernel ``src/repro/kernels/tiled_gemm.py:tiled_gemm_valid``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

#: the valid-length kernel's output tile and K step, which are also the
#: block sizes of its live-tile count
BLOCK_M, BLOCK_N, BLOCK_K = 64, 64, 32
#: fewest K steps a split-K slice takes: a slice of one step would move
#: more partial-sum bytes than weight bytes
MIN_SLICE_STEPS = 2

_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_VALID_PATHS = {torch.float32: "fma", torch.float16: "mma", torch.bfloat16: "mma"}
_SIGNATURES = {
    "tiled_gemm_valid": (ctypes.c_int, [
        ctypes.c_int, *[ctypes.c_void_p] * 6, *[ctypes.c_int] * 15, ctypes.c_void_p,
    ]),
}


#: dtypes of the dense kernel (its C interface's dtype codes)
_DENSE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_DENSE_PATHS = {"simt": 0, "wgmma": 1}
_DENSE_SIGNATURES = {
    "tiled_gemm": (ctypes.c_int, [
        ctypes.c_int, *[ctypes.c_void_p] * 3, *[ctypes.c_int] * 7, ctypes.c_void_p,
    ]),
}


def check_tiling(x: torch.Tensor, w: torch.Tensor, *, block_m: int = 256,
                 block_n: int = 256, block_k: int = 512):
    """The reference's checks of a dense GEMM: 2-D operands with a shared
    contraction, and block sizes (clipped to their axis) that divide it.
    Returns ``(m, n, k)``."""
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"expected 2-D operands, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(
            f"GEMM contraction mismatch: x is ({m}x{k}) but w is ({k2}x{n})"
        )
    block_m, block_n, block_k = min(block_m, m), min(block_n, n), min(block_k, k)
    if m % block_m or n % block_n or k % block_k:
        raise ValueError(
            f"GEMM ({m}x{k}) @ ({k}x{n}) does not tile into blocks "
            f"(block_m={block_m}, block_n={block_n}, block_k={block_k}): "
            "every block size must divide its axis — pick divisors or use "
            "kernels.tiled_gemm.divisor_block"
        )
    return m, n, k


def tiled_gemm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`tiled_gemm`: the fp32 product, cast
    back to ``x.dtype``."""
    return (x.float() @ w.float()).to(x.dtype)


def dense_path(dtype: torch.dtype, k: int, x_ptr: int, w_ptr: int, lda: int,
               ldw: int) -> str:
    """The dense kernel's path for these operands: ``"wgmma"`` where the
    dtype is bf16/fp16 and a TMA tensor map can describe both operands
    (16-byte-aligned base addresses and row strides, a contraction to
    stage), else ``"simt"``."""
    if dtype not in (torch.bfloat16, torch.float16) or k == 0:
        return "simt"
    esize = 2
    if x_ptr % 16 or w_ptr % 16 or (lda * esize) % 16 or (ldw * esize) % 16:
        return "simt"
    return "wgmma"


def tiled_gemm(x: torch.Tensor, w: torch.Tensor, *, block_m: int = 256,
               block_n: int = 256, block_k: int = 512) -> torch.Tensor:
    """Dense (M, K) @ (K, N) -> (M, N) in ``x.dtype``, fp32 accumulation.

    ``block_*`` are the reference kernel's tile sizes: each is clipped to
    its axis and must divide it, or this raises ``ValueError``, as the
    reference does.  They do not set the CUDA kernel's tiles."""
    m, n, k = check_tiling(x, w, block_m=block_m, block_n=block_n, block_k=block_k)
    if x.dtype != w.dtype or x.device != w.device:
        raise ValueError(f"operands differ: {x.dtype}@{x.device} vs "
                         f"{w.dtype}@{w.device}")
    if x.device.type == "cpu":
        return tiled_gemm_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no tiled_gemm kernel for {x.device}")
    if x.dtype not in _DENSE_DTYPES:
        raise ValueError(f"tiled_gemm kernel takes float32/bfloat16/float16, "
                         f"got {x.dtype}")
    if x.stride(1) != 1:
        x = x.contiguous()
    if w.stride(1) != 1:
        w = w.contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    path = dense_path(x.dtype, k, x.data_ptr(), w.data_ptr(), x.stride(0), w.stride(0))
    lib = build.load("tiled_gemm", _DENSE_SIGNATURES)
    err = lib.tiled_gemm(
        _DENSE_DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), out.data_ptr(),
        m, n, k, x.stride(0), w.stride(0), out.stride(0), _DENSE_PATHS[path],
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "tiled_gemm")
    tiled_gemm.launches += 1
    tiled_gemm.paths[path] += 1
    return out


tiled_gemm.launches = 0
tiled_gemm.paths = {"wgmma": 0, "simt": 0}


def divisor_block(extent: int, preferred: int) -> int:
    """Largest block size <= ``preferred`` that divides ``extent``."""
    if extent <= 0:
        raise ValueError(f"cannot pick a block for extent {extent}")
    b = min(preferred, extent)
    while extent % b:
        b -= 1
    return b


def _resolve(m: int, n: int, k: int, valid_m, valid_n, valid_k,
             seg_m: Optional[int], seg_n: Optional[int]):
    """Segment extents and valid counts clamped to them (``None`` = the
    whole axis is real)."""
    seg_m = m if seg_m is None else int(seg_m)
    seg_n = n if seg_n is None else int(seg_n)
    if seg_m <= 0 or seg_n <= 0 or m % seg_m or n % seg_n:
        raise ValueError(
            f"segments (seg_m={seg_m}, seg_n={seg_n}) must divide the "
            f"GEMM extents ({m}x{n})"
        )
    vals = []
    for name, v, ext in (("valid_m", valid_m, seg_m), ("valid_n", valid_n, seg_n),
                         ("valid_k", valid_k, k)):
        v = ext if v is None else int(v)
        if v < 0:
            raise ValueError(f"{name} must be >= 0, got {v}")
        vals.append(min(v, ext))
    return seg_m, seg_n, *vals


def dense_block_count(
    m: int, n: int, k: int, *, valid_m=None, valid_n=None, valid_k=None,
    seg_m: Optional[int] = None, seg_n: Optional[int] = None,
    block_m: int = BLOCK_M, block_n: int = BLOCK_N, block_k: int = BLOCK_K,
) -> int:
    """Analytic live-block count of :func:`tiled_gemm_valid`: segments times
    ``ceil(valid / block)`` per axis, at the kernel's tile sizes by default.
    It equals the reference's count wherever the blocks divide the
    segments."""
    seg_m, seg_n, vm, vn, vk = _resolve(m, n, k, valid_m, valid_n, valid_k,
                                        seg_m, seg_n)
    live_m = (m // seg_m) * -(-vm // block_m)
    live_n = (n // seg_n) * -(-vn // block_n)
    live_k = -(-vk // block_k)
    return live_m * live_n * live_k


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class ValidGemmPlan:
    """The valid-length kernel's grid for one call: ``n_tiles`` x
    ``m_tiles`` x ``splits`` blocks of ``BLOCK_M`` x ``BLOCK_N`` outputs.

    M tiles: where a segment is shorter than ``BLOCK_M`` (``pack`` > 1),
    one tile holds ``pack`` whole segments, so a decode batch of one-row
    segments reads each weight tile once; otherwise each segment is tiled
    on its own (``tiles_per_seg_m`` tiles, the last one partial).  N tiles
    never straddle an N segment.  The ``k_steps`` live K steps are split
    into ``splits`` slices of ``steps_per_split`` (the last may be
    shorter); each live tile's slices meet in an fp32 workspace, summed in
    slice order by the last block to arrive."""

    m: int
    n: int
    k: int
    seg_m: int
    seg_n: int
    valid_m: int
    valid_n: int
    valid_k: int
    pack: int
    tiles_per_seg_m: int
    m_tiles: int
    tiles_per_seg_n: int
    n_tiles: int
    live_m_tiles: int
    live_n_tiles: int
    k_steps: int
    steps_per_split: int
    splits: int

    def m_tile_rows(self, t: int) -> range:
        """The output rows of M tile ``t``."""
        if self.pack > 1:
            start = t * self.pack * self.seg_m
            return range(start, min(start + self.pack * self.seg_m, self.m))
        seg, i = divmod(t, self.tiles_per_seg_m)
        r0 = i * BLOCK_M
        start = seg * self.seg_m + r0
        return range(start, start + min(BLOCK_M, self.seg_m - r0))

    def m_tile_live_segments(self, t: int) -> int:
        """How many segments with real rows M tile ``t`` holds (0: dead)."""
        if self.valid_m == 0:
            return 0
        if self.pack > 1:
            return min(self.pack, self.m // self.seg_m - t * self.pack)
        return int((t % self.tiles_per_seg_m) * BLOCK_M < self.valid_m)

    def n_tile_live(self, t: int) -> bool:
        return (t % self.tiles_per_seg_n) * BLOCK_N < self.valid_n

    def slice_steps(self, z: int) -> range:
        """The K steps (of ``BLOCK_K``) slice ``z`` accumulates."""
        s0 = z * self.steps_per_split
        return range(s0, min(s0 + self.steps_per_split, self.k_steps))

    def live_count(self) -> int:
        """What the kernel's live-tile counter adds up: every live block
        adds its slice's K steps once per live segment it holds."""
        total = 0
        for tm in range(self.m_tiles):
            segs = self.m_tile_live_segments(tm)
            for tn in range(self.n_tiles):
                if segs and self.n_tile_live(tn):
                    total += sum(segs * len(self.slice_steps(z))
                                 for z in range(self.splits))
        return total

    @property
    def live_tiles(self) -> int:
        return self.live_m_tiles * self.live_n_tiles

    @property
    def workspace_floats(self) -> int:
        """fp32 partial sums the split needs (0 without a split)."""
        return self.live_tiles * self.splits * BLOCK_M * BLOCK_N if self.splits > 1 else 0


@functools.lru_cache(maxsize=4096)
def plan_valid_gemm(m: int, n: int, k: int, *, seg_m: int, seg_n: int, valid_m: int,
                    valid_n: int, valid_k: int, sm_count: int) -> ValidGemmPlan:
    """Lay out the valid-length kernel's grid (resolved, clamped counts).

    The kernel is bound by the bytes of its weight, so the plan fills the
    card: the live K steps are split so that live tiles x slices covers
    ``sm_count`` SMs about once, with at least ``MIN_SLICE_STEPS`` steps a
    slice."""
    if min(m, n, seg_m, seg_n, sm_count) <= 0 or m % seg_m or n % seg_n:
        raise ValueError(f"bad GEMM plan request {(m, n, seg_m, seg_n, sm_count)}")
    n_seg_m, n_seg_n = m // seg_m, n // seg_n
    pack = max(1, BLOCK_M // seg_m)
    if pack > 1:
        tpm = 1
        m_tiles = _cdiv(n_seg_m, pack)
        live_m = m_tiles if valid_m else 0
    else:
        tpm = _cdiv(seg_m, BLOCK_M)
        m_tiles = n_seg_m * tpm
        live_m = n_seg_m * _cdiv(valid_m, BLOCK_M)
    tpn = _cdiv(seg_n, BLOCK_N)
    live_n = n_seg_n * _cdiv(valid_n, BLOCK_N)
    k_steps = _cdiv(valid_k, BLOCK_K)
    live = live_m * live_n
    splits = 1
    if live and k_steps:
        want = _cdiv(sm_count, live)
        splits = max(1, min(want, k_steps // MIN_SLICE_STEPS))
    per = _cdiv(k_steps, splits) if k_steps else 0
    splits = _cdiv(k_steps, per) if per else 1
    return ValidGemmPlan(m, n, k, seg_m, seg_n, valid_m, valid_n, valid_k, pack, tpm,
                         m_tiles, tpn, n_seg_n * tpn, live_m, live_n, k_steps, per,
                         splits)


# per device: (fp32 partials, int32 per-tile arrival counters, kept at 0
# between launches)
_workspaces: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device: torch.device, floats: int, tiles: int):
    """The device's split-K workspace, grown to hold ``floats`` partials
    and ``tiles`` counters.  Launches on one stream reuse it one after the
    other; the kernel leaves every counter at 0."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    ws, cnt = _workspaces.get(idx, (None, None))
    if ws is None or ws.numel() < floats or cnt.numel() < tiles:
        if torch.cuda.is_current_stream_capturing():
            # it would come from the graph's pool and be freed with the graph
            raise RuntimeError(
                f"tiled_gemm_valid: the split-K workspace must grow to {floats} partials "
                f"and {tiles} counters while a CUDA graph is captured; warm up first: "
                "run the step once eagerly before capturing it")
        ws = torch.empty(max(floats, 1 if ws is None else ws.numel()),
                         dtype=torch.float32, device=device)
        cnt = torch.zeros(max(tiles, 1 if cnt is None else cnt.numel()),
                          dtype=torch.int32, device=device)
        _workspaces[idx] = (ws, cnt)
    return ws, cnt


def workspaces() -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
    """The split-K workspaces of every device as they stand.  A captured
    graph holds the ones it launched on: a later eager launch may grow
    (replace) them, and the graph goes on using the old buffers."""
    return tuple(_workspaces.values())


def _prefix_mask(extent: int, seg: int, valid: int, device) -> torch.Tensor:
    return (torch.arange(extent, device=device) % seg) < valid


def tiled_gemm_valid_plain(x: torch.Tensor, w: torch.Tensor, *, valid_m=None,
                           valid_n=None, valid_k=None, seg_m=None, seg_n=None,
                           count_blocks: bool = False):
    """Plain PyTorch version of :func:`tiled_gemm_valid`: the pad regions
    are selected away (so even non-finite garbage cannot leak), the product
    accumulates in fp32, and the live-block count is the analytic one."""
    m, k = x.shape
    n = w.shape[1]
    seg_m, seg_n, vm, vn, vk = _resolve(m, n, k, valid_m, valid_n, valid_k,
                                        seg_m, seg_n)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    rows = _prefix_mask(m, seg_m, vm, x.device)
    cols = _prefix_mask(n, seg_n, vn, x.device)
    kk = torch.arange(k, device=x.device) < vk
    xf = torch.where(rows[:, None] & kk[None, :], x.float(), zero)
    wf = torch.where(kk[:, None] & cols[None, :], w.float(), zero)
    out = torch.where(rows[:, None] & cols[None, :], xf @ wf, zero).to(x.dtype)
    if count_blocks:
        cnt = dense_block_count(m, n, k, valid_m=vm, valid_n=vn, valid_k=vk,
                                seg_m=seg_m, seg_n=seg_n)
        return out, torch.tensor(cnt, dtype=torch.int32)
    return out


def tiled_gemm_valid(x: torch.Tensor, w: torch.Tensor, *, valid_m=None,
                     valid_n=None, valid_k=None, seg_m=None, seg_n=None,
                     count_blocks: bool = False):
    """Valid-length (M, K) @ (K, N) -> (M, N) that sheds pad tiles.

    valid_m / valid_n: real leading rows / columns of each ``seg_m`` /
        ``seg_n`` segment (host ints: in the ring they are per-device and
        per-step values known before launch, so nothing syncs).
    valid_k: real leading entries of the contraction axis.
    ``None`` means fully real on that axis.  With ``count_blocks=True``
    also returns the number of live (m, n, k) tiles as an int32 tensor.
    The same call gives bitwise-equal output every time: the split-K
    slices are summed in a fixed order.
    """
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"expected 2-D operands, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(
            f"GEMM contraction mismatch: x is ({m}x{k}) but w is ({k2}x{n})"
        )
    if x.dtype != w.dtype or x.device != w.device:
        raise ValueError(f"operands differ: {x.dtype}@{x.device} vs "
                         f"{w.dtype}@{w.device}")
    if x.device.type == "cpu":
        return tiled_gemm_valid_plain(
            x, w, valid_m=valid_m, valid_n=valid_n, valid_k=valid_k,
            seg_m=seg_m, seg_n=seg_n, count_blocks=count_blocks)
    if x.device.type != "cuda":
        raise ValueError(f"no tiled_gemm_valid kernel for {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"tiled_gemm_valid kernel takes float32/float16/bfloat16, "
                         f"got {x.dtype}")
    seg_m, seg_n, vm, vn, vk = _resolve(m, n, k, valid_m, valid_n, valid_k,
                                        seg_m, seg_n)
    if x.stride(1) != 1:
        x = x.contiguous()
    if w.stride(1) != 1:
        w = w.contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    counter = (torch.zeros(1, dtype=torch.int32, device=x.device)
               if count_blocks else None)
    if m and n:
        plan = plan_valid_gemm(m, n, k, seg_m=seg_m, seg_n=seg_n, valid_m=vm,
                               valid_n=vn, valid_k=vk, sm_count=build.sm_count(x.device))
        ws = cnt = None
        if plan.splits > 1:
            ws, cnt = _workspace(x.device, plan.workspace_floats, plan.live_tiles)
        lib = build.load("tiled_gemm_valid", _SIGNATURES)
        err = lib.tiled_gemm_valid(
            _DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), out.data_ptr(),
            None if counter is None else counter.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if cnt is None else cnt.data_ptr(),
            m, n, k, x.stride(0), w.stride(0), out.stride(0), seg_m, seg_n,
            vm, vn, vk, plan.pack, plan.m_tiles, plan.steps_per_split, plan.splits,
            torch.cuda.current_stream(x.device).cuda_stream)
        build.check(err, "tiled_gemm_valid")
        tiled_gemm_valid.launches += 1
        tiled_gemm_valid.paths[_VALID_PATHS[x.dtype]] += 1
    if count_blocks:
        return out, counter[0]
    return out


tiled_gemm_valid.launches = 0
tiled_gemm_valid.paths = {"mma": 0, "fma": 0}
