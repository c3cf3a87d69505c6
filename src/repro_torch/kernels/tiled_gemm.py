"""Tiled GEMMs: the dense blocked GEMM and the valid-length GEMM of every
ring tile.

:func:`tiled_gemm` computes a dense ``(M, K) @ (K, N)`` with an fp32
accumulator, in the operands' dtype.  It keeps the reference's contract
(block sizes clipped to their axis must divide it), but the block sizes
only decide which shapes are accepted: the CUDA kernel of
``csrc/tiled_gemm.cu`` picks its own tiles.  On a CPU tensor it runs
:func:`tiled_gemm_plain`.  It replaces the TPU kernel
``src/repro/kernels/tiled_gemm.py:tiled_gemm``; as there, no serving path
calls it (its entry point is ``ops.tiled_gemm``).

:func:`tiled_gemm_valid` computes ``(M, K) @ (K, N)`` with an fp32
accumulator where only a valid prefix of each ``seg_m``-row M segment, of
each ``seg_n``-column N segment, and of the contraction is real; pad
outputs are exactly zero whatever the pad regions of the operands hold,
and tiles wholly in the padding issue no work.  On a CUDA tensor it
launches the hand-written kernel of ``csrc/tiled_gemm_valid.cu``; on a CPU
tensor it runs :func:`tiled_gemm_valid_plain`, the same function in plain
PyTorch.  It replaces the TPU kernel
``src/repro/kernels/tiled_gemm.py:tiled_gemm_valid``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

#: the CUDA kernel's output tile and K step
BLOCK_M, BLOCK_N, BLOCK_K = 64, 64, 32

_DTYPES = {torch.float32: 0, torch.float16: 1}
_SIGNATURES = {
    "tiled_gemm_valid": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, *[ctypes.c_int] * 11, ctypes.c_void_p,
    ]),
}


#: dtypes of the dense kernel (its C interface's dtype codes)
_DENSE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_DENSE_SIGNATURES = {
    "tiled_gemm": (ctypes.c_int, [
        ctypes.c_int, *[ctypes.c_void_p] * 3, *[ctypes.c_int] * 6, ctypes.c_void_p,
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
    lib = build.load("tiled_gemm", _DENSE_SIGNATURES)
    err = lib.tiled_gemm(
        _DENSE_DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), out.data_ptr(),
        m, n, k, x.stride(0), w.stride(0), out.stride(0),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "tiled_gemm")
    tiled_gemm.launches += 1
    return out


tiled_gemm.launches = 0


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
        raise ValueError(f"tiled_gemm_valid kernel takes float32/float16, "
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
        lib = build.load("tiled_gemm_valid", _SIGNATURES)
        err = lib.tiled_gemm_valid(
            _DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), out.data_ptr(),
            None if counter is None else counter.data_ptr(),
            m, n, k, x.stride(0), w.stride(0), out.stride(0), seg_m, seg_n,
            vm, vn, vk, torch.cuda.current_stream(x.device).cuda_stream)
        build.check(err, "tiled_gemm_valid")
        tiled_gemm_valid.launches += 1
    if count_blocks:
        return out, counter[0]
    return out


tiled_gemm_valid.launches = 0
