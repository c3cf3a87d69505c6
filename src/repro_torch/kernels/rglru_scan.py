"""RG-LRU sequence scan: h_t = a_t * h_{t-1} + b_t along the sequence.

:func:`rglru_scan` is RecurrentGemma's recurrence over a prefill: per
(batch, width column) a sequential loop over S carrying h in fp32.  On a
CUDA tensor it launches the hand-written kernel of ``csrc/rglru_scan.cu``
on the plan :func:`plan_scan` lays out; on a CPU tensor it runs
:func:`rglru_scan_plain`.  The kernel has two paths, counted in
``rglru_scan.paths``: ``"tma"`` (rows of a 16-byte multiple, 16-byte
aligned inputs: 32-column strips streamed through a TMA ring of shared
memory) and ``"simt"`` (any other shape: one thread per column).  Both
give fp32 results bitwise equal to the plain version.  It replaces the
TPU kernel ``src/repro/kernels/rglru_scan.py:rglru_scan_kernel``.

:class:`RGLRUScanFn` gives it a gradient for training.  The backward of
h_t = a_t h_{t-1} + b_t is the same linear recurrence run backwards,
g_t = dh_t + a_{t+1} g_{t+1}, so :func:`rglru_scan_backward` launches the
same kernel on time-reversed operands (torch has no negative strides, so
the reversed a and dh are copies, and so is the flip of the result back:
three extra reads and writes of a (B, S, w) tensor), then da = g h_{t-1},
db = g and dh0 = a_0 g_0 in elementwise torch ops.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_PATHS = {"simt": 0, "tma": 1}
_SIGNATURES = {
    "rglru_scan": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, *[ctypes.c_void_p] * 5, *[ctypes.c_int] * 8,
        ctypes.c_void_p,
    ]),
}

#: columns a TMA block owns (one lane of its consumer warp each)
STRIP = 32
#: bytes of one ring stage: rows x STRIP of a, then of b
STAGE_BYTES = 8192
MAX_STAGES = 8
#: columns a simt block owns (one thread each)
SIMT_STRIP = 64
#: shared memory of one H100 SM, what the system keeps per resident
#: block, and the most one block may take
SM_SMEM, BLOCK_RESERVED, BLOCK_SMEM = 233_472, 1024, 232_448
#: the kernel's static shared memory (a full and an empty mbarrier per
#: stage) and the slack that aligns the ring to 128 bytes
STATIC_SMEM, ALIGN = 16 * MAX_STAGES, 128


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """One launch of the scan kernel: ``grid`` = (column strips, batch
    rows) blocks of 64 threads, block ``(i, b)`` owning columns ``[i *
    strip, (i + 1) * strip)`` of batch row ``b`` (those past ``w``
    masked).  On the ``"tma"`` path a block streams its strip through
    ``stages`` ring stages of ``rows`` sequence rows (``smem_bytes`` of
    dynamic shared memory); the ``"simt"`` path has no ring (0s)."""

    path: str
    strip: int
    rows: int
    stages: int
    grid: Tuple[int, int]
    smem_bytes: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def plan_scan(b: int, s: int, w: int, esize: int, sm_count: int, *,
              aligned: bool = True) -> ScanPlan:
    """Lay out the scan kernel's launch for (b, s, w) inputs of ``esize``
    bytes an element.  ``aligned``: both inputs start on a 16-byte
    boundary.

    The kernel is bound by bytes, so the TMA ring is as deep as shared
    memory allows for the blocks that share an SM (``ceil(blocks /
    sm_count)``), up to ``MAX_STAGES`` and to the stages the sequence
    fills, at least 2 where there are 2 to fill."""
    if min(b, s, w, sm_count) <= 0 or esize not in (2, 4):
        raise ValueError(f"bad scan plan request {(b, s, w, esize, sm_count)}")
    if not aligned or (w * esize) % 16:
        return ScanPlan("simt", SIMT_STRIP, 0, 0, (_cdiv(w, SIMT_STRIP), b), 0)
    rows = STAGE_BYTES // (2 * STRIP * esize)
    strips = _cdiv(w, STRIP)
    per_sm = _cdiv(strips * b, sm_count)
    budget = SM_SMEM // per_sm - BLOCK_RESERVED - STATIC_SMEM - ALIGN
    tiles = _cdiv(s, rows)
    stages = max(min(2, tiles), min(MAX_STAGES, budget // STAGE_BYTES, tiles))
    return ScanPlan("tma", STRIP, rows, stages, (strips, b), stages * STAGE_BYTES + ALIGN)


def rglru_scan_plain(a, b, h0):
    """Plain PyTorch version of :func:`rglru_scan`: the same sequential
    fp32 recurrence, one step per sequence row."""
    bsz, s, w = a.shape
    h = h0.float()
    h_seq = torch.empty((bsz, s, w), dtype=torch.float32, device=a.device)
    for t in range(s):
        h = a[:, t].float() * h + b[:, t].float()
        h_seq[:, t] = h
    return h_seq.to(a.dtype), h.to(a.dtype)


def _check(a, b, h0):
    if a.dim() != 3 or b.shape != a.shape or h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"rglru_scan shapes: a {tuple(a.shape)}, b {tuple(b.shape)}, "
                         f"h0 {tuple(h0.shape)}; want (B, S, w), (B, S, w), (B, w)")
    if a.shape[1] == 0:
        raise ValueError("rglru_scan needs at least one sequence row")


def rglru_scan(a, b, h0):
    """a, b: (B, S, w) of one float dtype; h0: (B, w) of any float dtype.

    Returns ``(h_seq (B, S, w), h_last (B, w))`` in ``a.dtype``; h is
    carried in fp32.  Any S >= 1 and any w.
    """
    _check(a, b, h0)
    if a.device.type == "cpu":
        return rglru_scan_plain(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"no rglru_scan kernel for {a.device}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise ValueError(f"rglru_scan kernel takes float32/bfloat16/float16, "
                         f"got {a.dtype}/{b.dtype}")
    a, b = a.contiguous(), b.contiguous()
    h0 = h0.to(torch.float32).contiguous()
    bsz, s, w = a.shape
    h_seq = torch.empty_like(a)
    h_last = torch.empty((bsz, w), dtype=a.dtype, device=a.device)
    plan = plan_scan(bsz, s, w, a.element_size(), build.sm_count(a.device),
                     aligned=a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
    lib = build.load("rglru_scan", _SIGNATURES)
    err = lib.rglru_scan(
        _DTYPES[a.dtype], _PATHS[plan.path], a.data_ptr(), b.data_ptr(), h0.data_ptr(),
        h_seq.data_ptr(), h_last.data_ptr(), bsz, s, w, plan.strip, plan.rows,
        plan.stages, plan.grid[0], plan.smem_bytes,
        torch.cuda.current_stream(a.device).cuda_stream)
    build.check(err, "rglru_scan")
    rglru_scan.launches += 1
    rglru_scan.paths[plan.path] += 1
    return h_seq, h_last


rglru_scan.launches = 0
rglru_scan.paths = {"tma": 0, "simt": 0}


def rglru_scan_backward(a, h0, h_seq, dh_seq, dh_last):
    """Gradients (da, db, dh0) of :func:`rglru_scan` at (a, h0) with
    output ``h_seq``, for the output gradients ``dh_seq`` (B, S, w) and
    ``dh_last`` (B, w).

    g_t = dh_t + a_{t+1} g_{t+1} with dh_last added into g_{S-1} is the
    forward recurrence on reversed time: A_r = a_{S-r} (A_0 unused: the
    carry starts at 0), B_r = dh_{S-1-r}; :func:`rglru_scan` runs it (the
    kernel on CUDA tensors).  Then db_t = g_t, da_t = g_t h_{t-1} with
    h_{-1} = h0, and dh0 = a_0 g_0."""
    bsz, s, w = a.shape
    a_rev = torch.zeros_like(a)
    a_rev[:, 1:] = a[:, 1:].flip(1)
    b_rev = dh_seq.to(a.dtype).flip(1)  # flip copies: b_rev is contiguous and ours
    b_rev[:, 0] += dh_last.to(a.dtype)
    g_rev, _ = rglru_scan(a_rev, b_rev,
                          torch.zeros((bsz, w), dtype=torch.float32, device=a.device))
    g = g_rev.flip(1)
    h_prev = torch.cat([h0.to(h_seq.dtype)[:, None], h_seq[:, :-1]], dim=1)
    da = g * h_prev
    dh0 = (a[:, 0].float() * g[:, 0].float()).to(h0.dtype)
    return da, g, dh0


class RGLRUScanFn(torch.autograd.Function):
    """:func:`rglru_scan` with a gradient.  Forward and backward each run
    the scan once: the kernel on CUDA tensors (each a counted launch),
    the plain version on CPU tensors.  Saves a, h0 and h_seq."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h_seq, h_last = rglru_scan(a, b, h0)
        ctx.save_for_backward(a, h0, h_seq)
        return h_seq, h_last

    @staticmethod
    def backward(ctx, dh_seq, dh_last):
        a, h0, h_seq = ctx.saved_tensors
        return rglru_scan_backward(a, h0, h_seq, dh_seq, dh_last)
