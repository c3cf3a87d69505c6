"""Dispatch point of ``ExecPlan.compute_backend`` for per-shard compute.

:func:`gemm`, :func:`ragged_attention` and :func:`connective_group` are what
the HMP executor (``core/hmp.py``) and the ring primitives (``core/ring.py``)
call: the first two per device shard, the connective once per site for
all the shards.  For the GEMM, ``backend="eager"`` keeps the
padded dense product with the valid counts applied as masks (the
pad-and-mask oracle: every pad block still executes); ``backend="kernel"``
routes through the valid-length kernel, which skips whole pad tiles.  Both
compute the same function of the valid regions whatever the pad regions
hold.

:func:`flash_attention` and :func:`rglru_scan` are what the model zoo
(``models/``) calls, and :func:`tiled_gemm` is the dense GEMM op that no
model calls (the zoo's projections stay ``torch.matmul``, as they are
einsums outside any kernel in the reference): ``backend="kernel"``
launches the kernel (its plain version on a CPU tensor),
``backend="eager"`` runs the plain version on any device.  When an input
of :func:`flash_attention` or :func:`rglru_scan` requires a gradient (a
train step), the kernel backend goes through the kernel's
``torch.autograd.Function``, whose forward is the same launch; with no
gradient (every serving call) it launches the wrapper directly.  Their
kernel-backend calls are counted by signature in :data:`CALLS`
(:func:`call_log`), so a run can replay each one against the plain version.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List

import torch

from repro_torch.core.execplan import COMPUTE_BACKENDS
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import rglru_scan as _scan
from repro_torch.kernels.flash_attention import ragged_flash_attention
from repro_torch.kernels.fused_connective import fused_connective_group
from repro_torch.kernels import tiled_gemm as _gemm
from repro_torch.kernels.tiled_gemm import tiled_gemm_valid

#: the kernel wrappers whose launches a run can count
KERNELS = {
    "tiled_gemm_valid": tiled_gemm_valid,
    "ragged_flash_attention": ragged_flash_attention,
    "fused_connective": fused_connective_group,
    "flash_attention": _flash.flash_attention,
    "rglru_scan": _scan.rglru_scan,
    "tiled_gemm": _gemm.tiled_gemm,
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def path_counts() -> Dict[str, Dict[str, int]]:
    """Launches per internal path of each kernel (tensor cores or CUDA
    cores; the scan's TMA ring or its plain loop; the connective's rows in
    registers or its loop), since the last :func:`reset_launch_counts`."""
    return {name: dict(fn.paths) for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        fn.paths = dict.fromkeys(fn.paths, 0)


#: the kernel-backend calls of :func:`flash_attention` and :func:`rglru_scan`
#: since the last :func:`reset_call_log`, counted by signature: for
#: attention the shapes and strides of q, k and v, the dtype, the masks
#: and whether a ``kv_len`` was given; for the scan the shape of ``a`` and
#: the dtypes of ``a`` and ``h0``.  Enough to replay each distinct call
#: against its plain version.
CALLS = {"flash_attention": Counter(), "rglru_scan": Counter()}


def call_log() -> Dict[str, List]:
    """``[signature, calls]`` of each distinct kernel-backend call since the
    last :func:`reset_call_log`, by kernel, in order."""
    return {name: sorted([list(sig), n] for sig, n in calls.items())
            for name, calls in CALLS.items()}


def reset_call_log() -> None:
    for calls in CALLS.values():
        calls.clear()


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _check_backend(backend: str) -> None:
    if backend not in COMPUTE_BACKENDS:
        raise ValueError(f"unknown compute backend {backend!r}; "
                         f"one of {COMPUTE_BACKENDS}")


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _mask(t: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    return torch.where(keep, t, torch.zeros((), dtype=t.dtype, device=t.device))


def gemm(x, w, *, backend: str = "eager", valid_m=None, valid_n=None,
         valid_k=None, seg_n=None, count_blocks: bool = False):
    """(..., M, K) @ (K, N) through the selected compute backend.

    Leading dims of ``x`` fold into the GEMM M axis as equal segments (one
    per batch row), each with ``valid_m`` real leading rows.  ``valid_n``
    names the real leading columns of each ``seg_n``-column segment of
    ``w`` (e.g. the q/k/v thirds of a fused QKV weight) and ``valid_k`` the
    real contraction prefix.  ``count_blocks=True`` (kernel only) also
    returns the live-tile count.
    """
    _check_backend(backend)
    if backend == "eager":
        if count_blocks:
            raise ValueError("count_blocks is a kernel-backend measurement")
        m, kk = x.shape[-2], x.shape[-1]
        n = w.shape[1]
        if valid_m is not None:
            x = _mask(x, (torch.arange(m, device=x.device) < valid_m)[:, None])
        if valid_k is not None:
            x = _mask(x, torch.arange(kk, device=x.device) < valid_k)
        out = torch.matmul(x, w)
        if valid_n is not None:
            seg = n if seg_n is None else seg_n
            out = _mask(out, (torch.arange(n, device=x.device) % seg) < valid_n)
        return out
    lead = x.shape[:-2]
    seg_m = x.shape[-2]
    res = tiled_gemm_valid(
        x.reshape(-1, x.shape[-1]), w, valid_m=valid_m, valid_n=valid_n,
        valid_k=valid_k, seg_m=seg_m, seg_n=seg_n, count_blocks=count_blocks)
    if count_blocks:
        out, cnt = res
        return out.reshape(*lead, seg_m, w.shape[1]), cnt
    return res.reshape(*lead, seg_m, w.shape[1])


def ragged_attention(q, k, v, *, positions, valid_heads=None):
    """Causal attention over a padded ragged row order, (B, S, H, hd)
    executor layout.  ``positions`` is the static ``SeqLayout.positions``
    map (-1 = pad row; ``arange`` for a dense layout) and ``valid_heads``
    this device's real head count.  Pad rows/heads come out exactly zero;
    always the kernel path (the eager equivalent is the caller's masked
    attention)."""
    out = ragged_flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        positions=positions, valid_heads=valid_heads)
    return out.transpose(1, 2)


def connective_group(xs, ress, scales, biases):
    """Fused residual-add + layernorm over the (..., S_i, d) activations of
    the shards of one connective site that this process holds — the Galaxy
    connective block as one pass and one launch (dropout off at
    inference): all D shards on a ``LocalRing``, one a rank on a
    ``ProcessRing``."""
    return fused_connective_group(xs, ress, None, scales, biases, rate=0.0)


def connective(x, res, scale, bias):
    """:func:`connective_group` of one shard."""
    return connective_group([x], [res], [scale], [bias])[0]


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    backend: str = "kernel", kv_len=None):
    """Dense attention, q (B, H, Sq, hd) against k/v (B, Hkv, Sk, hd), with
    causal and sliding-window masks: the flash kernel, or its plain
    version on ``backend="eager"``.  ``kv_len`` (B,) int32 on the device:
    each batch entry's key count, a serving chunk's end (no gradient)."""
    _check_backend(backend)
    if backend == "eager":
        return _flash.flash_attention_plain(q, k, v, causal=causal, window=window,
                                            kv_len=kv_len)
    CALLS["flash_attention"][(tuple(q.shape), q.stride(), tuple(k.shape), k.stride(),
                              v.stride(), _dtype(q), bool(causal), int(window),
                              kv_len is not None)] += 1
    if kv_len is None and _needs_grad(q, k, v):
        return _flash.FlashAttentionFn.apply(q, k, v, causal, window)
    return _flash.flash_attention(q, k, v, causal=causal, window=window, kv_len=kv_len)


def rglru_scan(a, b, h0, *, backend: str = "kernel"):
    """h_t = a_t * h_{t-1} + b_t along axis 1 of (B, S, w): the scan
    kernel, or its plain version on ``backend="eager"``.  Returns
    ``(h_seq, h_last)``."""
    _check_backend(backend)
    if backend == "eager":
        return _scan.rglru_scan_plain(a, b, h0)
    CALLS["rglru_scan"][(tuple(a.shape), _dtype(a), _dtype(h0))] += 1
    if _needs_grad(a, b, h0):
        return _scan.RGLRUScanFn.apply(a, b, h0)
    return _scan.rglru_scan(a, b, h0)


def tiled_gemm(x, w, *, block_m: int = 256, block_n: int = 256, block_k: int = 512,
               backend: str = "kernel"):
    """Dense (M, K) @ (K, N) with an fp32 accumulator: the dense GEMM
    kernel, or its plain version on ``backend="eager"``.  Both check the
    reference's tiling contract (``block_*`` clipped to their axis must
    divide it)."""
    _check_backend(backend)
    if backend == "kernel":
        return _gemm.tiled_gemm(x, w, block_m=block_m, block_n=block_n, block_k=block_k)
    _gemm.check_tiling(x, w, block_m=block_m, block_n=block_n, block_k=block_k)
    return _gemm.tiled_gemm_plain(x, w)
