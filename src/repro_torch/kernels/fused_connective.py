"""Fused connective block: dropout -> residual add -> layernorm, one pass.

The paper puts the connective blocks on the sequence axis because these
element-wise ops are memory-bandwidth bound (§III-B-3).  The fused kernel
reads x, the residual (and the keep-mask when dropout is on) once and
writes the output once: ``(x * keep / (1 - rate) if rate > 0) + res``,
then LayerNorm in fp32 (eps 1e-5), then ``* scale + bias``.  Dropout takes
a caller-supplied keep-mask so the kernel is deterministic.

:func:`fused_connective_group` computes it for the row shards of one
connective site (one per Galaxy device, each with its own tensors, scale
and bias) in one launch of the CUDA kernel of ``csrc/fused_connective.cu``
(a warp per row), or in ``ceil(D / MAX_SHARDS)`` launches for more than
``MAX_SHARDS`` shards (:func:`pack_group`); on CPU tensors it runs
:func:`fused_connective_group_plain`.  :func:`fused_connective` is the
group of one.  The kernel has two paths, chosen by :func:`connective_path`
and counted in ``fused_connective_group.paths``: ``"warp"`` (rows held in
registers: d a multiple of the 16-byte vector, at most ``ROW_ELEMS``
wide, 16-byte-aligned rows) and ``"loop"`` (any other row).  It replaces
the TPU kernel ``src/repro/kernels/fused_connective.py:fused_connective``;
the reference's ``block_s`` tiling is a Pallas artefact and is gone: any
row count runs.
"""
from __future__ import annotations

import ctypes
import dataclasses
import itertools
import struct
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import build

#: shard descriptors one launch carries
MAX_SHARDS = 8
#: rows a block computes, one warp each
ROWS_PER_BLOCK = 4
#: widest row the "warp" path holds in registers (32 lanes x 80 fp32 values)
ROW_ELEMS = 2560

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_PATHS = {"warp": 0, "loop": 1}
_SIGNATURES = {
    "fused_connective": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, *[ctypes.c_int] * 3,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]),
}


@dataclasses.dataclass(frozen=True)
class ConnectiveLaunch:
    """One launch of the connective kernel: the group's shards
    ``shards`` (indices, none of them empty), whose rows the grid takes
    one after another (``row0``: the prefix of their row counts), in
    ``blocks`` blocks of ``ROWS_PER_BLOCK`` warps, one row a warp."""

    shards: Tuple[int, ...]
    row0: Tuple[int, ...]
    blocks: int


def pack_group(rows: Sequence[int]) -> List[ConnectiveLaunch]:
    """The launches of a group whose shards have ``rows`` rows: shards
    with rows, ``MAX_SHARDS`` to a launch, in order (none for a group with
    no rows)."""
    live = [i for i, r in enumerate(rows) if r > 0]
    out = []
    for c in range(0, len(live), MAX_SHARDS):
        idx = tuple(live[c:c + MAX_SHARDS])
        row0 = (0, *itertools.accumulate(rows[i] for i in idx))
        out.append(ConnectiveLaunch(idx, row0, -(-row0[-1] // ROWS_PER_BLOCK)))
    return out


def connective_path(dtype: torch.dtype, d: int, ptrs: Sequence[int],
                    strides: Sequence[int]) -> str:
    """``"warp"`` where a row fits the registers (d a multiple of the
    16-byte vector, ``d <= ROW_ELEMS``) and every pointer and row stride
    of the launch is 16-byte aligned; else ``"loop"``."""
    esize = torch.finfo(dtype).bits // 8
    if d % (16 // esize) or d > ROW_ELEMS:
        return "loop"
    if any(p % 16 for p in ptrs) or any((s * esize) % 16 for s in strides):
        return "loop"
    return "warp"


def fused_connective_plain(x, res, keep_mask, scale, bias, *, rate: float = 0.0,
                           eps: float = 1e-5):
    """Plain PyTorch version of :func:`fused_connective` (fp32 math)."""
    xf = x.float()
    if rate > 0:
        xf = xf * keep_mask.float() / (1.0 - rate)
    y = xf + res.float()
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    out = (y - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return out.to(x.dtype)


def fused_connective_group_plain(xs, ress, keeps, scales, biases, *, rate: float = 0.0,
                                 eps: float = 1e-5):
    """Plain PyTorch version of :func:`fused_connective_group`: the plain
    connective shard by shard."""
    keeps = [None] * len(xs) if keeps is None else keeps
    return [fused_connective_plain(x, r, k, s, b, rate=rate, eps=eps)
            for x, r, k, s, b in zip(xs, ress, keeps, scales, biases)]


def _check_group(xs, ress, keeps, scales, biases, rate):
    n = len(xs)
    if not n or any(len(t) != n for t in (ress, scales, biases)) or (
            keeps is not None and len(keeps) != n):
        raise ValueError("a connective group needs as many x, res, (keep,) scale and "
                         "bias tensors, at least one")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"rate must lie in [0, 1), got {rate}")
    x0 = xs[0]
    d = x0.shape[-1]
    for i, (x, res, scale, bias) in enumerate(zip(xs, ress, scales, biases)):
        if x.dim() < 2 or res.shape != x.shape or x.shape[-1] != d or d < 1:
            raise ValueError(f"shard {i}: x {tuple(x.shape)} and res {tuple(res.shape)} "
                             f"must be the same (..., {d})")
        if scale.shape != (d,) or bias.shape != (d,):
            raise ValueError(f"shard {i}: scale/bias must be ({d},)")
        if x.dtype != x0.dtype or x.device != x0.device:
            raise ValueError(f"shard {i}: {x.dtype}@{x.device}, shard 0: "
                             f"{x0.dtype}@{x0.device}")
        if rate > 0 and (keeps is None or keeps[i] is None or keeps[i].shape != x.shape):
            raise ValueError(f"rate > 0 needs a keep_mask of x's shape (shard {i})")


def _as_rows(t, d: int, dtype: torch.dtype):
    """``(t, rows, row stride)`` as the kernel reads ``t``: its leading
    dims are rows of ``d`` unit-strided elements.  A contiguous ``t`` is
    taken as it is, any other as ``reshape(-1, d)`` (copied only where
    that cannot be a view of unit-strided rows)."""
    if t.dtype != dtype:
        t = t.to(dtype)  # a 0/1 keep mask is exact in any float dtype
    if t.is_contiguous():
        return t, t.numel() // d, d
    t = t.reshape(-1, d)
    if t.stride(1) != 1:
        t = t.contiguous()
    return t, t.shape[0], t.stride(0)


def fused_connective_group(xs, ress, keeps, scales, biases, *, rate: float = 0.0,
                           eps: float = 1e-5):
    """The connective of each shard: ``xs[i], ress[i]``: (..., d) of one
    dtype, every leading index a row (any number, 0 included); ``keeps``:
    0/1 masks of those shapes, read only when ``rate > 0`` (may be None
    otherwise); ``scales[i], biases[i]``: (d,).  Returns the outputs in
    x's shapes and dtype.

    On CUDA tensors the shards' rows go through one kernel launch, or
    ``ceil(D / MAX_SHARDS)`` launches for ``D > MAX_SHARDS`` shards with
    rows; a group with no rows launches nothing."""
    _check_group(xs, ress, keeps, scales, biases, rate)
    dev = xs[0].device
    if dev.type == "cpu":
        return fused_connective_group_plain(xs, ress, keeps, scales, biases,
                                            rate=rate, eps=eps)
    if dev.type != "cuda":
        raise ValueError(f"no fused_connective kernel for {dev}")
    dtype = xs[0].dtype
    if dtype not in _DTYPES:
        raise ValueError(f"fused_connective kernel takes float32/bfloat16/float16, "
                         f"got {dtype}")
    if any(t.dtype != dtype for t in (*scales, *biases)):
        raise ValueError(f"the fused_connective kernel reads scale and bias in x's "
                         f"dtype {dtype}")
    has_keep = rate > 0
    d = xs[0].shape[-1]
    outs = [torch.empty(x.shape, dtype=dtype, device=dev) for x in xs]
    xr = [_as_rows(x, d, dtype) for x in xs]
    rr = [_as_rows(r, d, dtype) for r in ress]
    kr = [_as_rows(k, d, dtype) for k in keeps] if has_keep else xr
    stream = torch.cuda.current_stream(dev).cuda_stream
    for launch in pack_group([rows for _, rows, _ in xr]):
        desc, ptrs, strides = [], [], []
        for i in launch.shards:
            (x, _, sx), (r, _, sr), (k, _, sk) = xr[i], rr[i], kr[i]
            p = [x.data_ptr(), r.data_ptr(), k.data_ptr(), outs[i].data_ptr(),
                 scales[i].data_ptr(), biases[i].data_ptr()]
            desc += p + [sx, sr, sk, d]
            ptrs += p if has_keep else p[:2] + p[3:]
            strides += [sx, sr, sk] if has_keep else [sx, sr]
        path = connective_path(dtype, d, ptrs, strides)
        n = len(launch.shards)
        lib = build.load("fused_connective", _SIGNATURES)
        err = lib.fused_connective(
            _DTYPES[dtype], _PATHS[path], struct.pack(f"{len(desc)}q", *desc),
            struct.pack(f"{n + 1}i", *launch.row0), n, d, int(has_keep),
            1.0 / (1.0 - rate), eps, launch.row0[-1], launch.blocks, stream)
        build.check(err, "fused_connective")
        fused_connective_group.launches += 1
        fused_connective_group.paths[path] += 1
    return outs


fused_connective_group.launches = 0
fused_connective_group.paths = {"warp": 0, "loop": 0}


def fused_connective(x, res, keep_mask, scale, bias, *, rate: float = 0.0,
                     eps: float = 1e-5):
    """x, res: (S, d); keep_mask: (S, d) 0/1 (read only when ``rate > 0``,
    may be None otherwise); scale, bias: (d,).  Returns (S, d) in x.dtype:
    :func:`fused_connective_group` of one shard."""
    return fused_connective_group([x], [res], [keep_mask], [scale], [bias],
                                  rate=rate, eps=eps)[0]
