"""Dispatch point of ``ExecPlan.compute_backend`` for per-shard compute.

:func:`gemm`, :func:`ragged_attention` and :func:`connective` are what the
HMP executor (``core/hmp.py``) and the ring primitives (``core/ring.py``)
call per device shard.  For the GEMM, ``backend="eager"`` keeps the
padded dense product with the valid counts applied as masks (the
pad-and-mask oracle: every pad block still executes); ``backend="kernel"``
routes through the valid-length kernel, which skips whole pad tiles.  Both
compute the same function of the valid regions whatever the pad regions
hold.

:func:`flash_attention` and :func:`rglru_scan` are what the model zoo
(``models/``) calls: ``backend="kernel"`` launches the kernel (its plain
version on a CPU tensor), ``backend="eager"`` runs the plain version on
any device.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.execplan import COMPUTE_BACKENDS
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import rglru_scan as _scan
from repro_torch.kernels.flash_attention import ragged_flash_attention
from repro_torch.kernels.fused_connective import fused_connective
from repro_torch.kernels.tiled_gemm import tiled_gemm_valid

#: the kernel wrappers whose launches a run can count
KERNELS = {
    "tiled_gemm_valid": tiled_gemm_valid,
    "ragged_flash_attention": ragged_flash_attention,
    "fused_connective": fused_connective,
    "flash_attention": _flash.flash_attention,
    "rglru_scan": _scan.rglru_scan,
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _check_backend(backend: str) -> None:
    if backend not in COMPUTE_BACKENDS:
        raise ValueError(f"unknown compute backend {backend!r}; "
                         f"one of {COMPUTE_BACKENDS}")


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


def connective(x, res, scale, bias):
    """Fused residual-add + layernorm over (..., S, d) activations — the
    Galaxy connective block as one pass (dropout off at inference)."""
    lead = x.shape[:-1]
    d = x.shape[-1]
    out = fused_connective(x.reshape(-1, d), res.reshape(-1, d), None, scale,
                           bias, rate=0.0)
    return out.reshape(*lead, d)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    backend: str = "kernel"):
    """Dense attention, q (B, H, Sq, hd) against k/v (B, Hkv, Sk, hd), with
    causal and sliding-window masks: the flash kernel, or its plain
    version on ``backend="eager"``."""
    _check_backend(backend)
    fn = _flash.flash_attention if backend == "kernel" else _flash.flash_attention_plain
    return fn(q, k, v, causal=causal, window=window)


def rglru_scan(a, b, h0, *, backend: str = "kernel"):
    """h_t = a_t * h_{t-1} + b_t along axis 1 of (B, S, w): the scan
    kernel, or its plain version on ``backend="eager"``.  Returns
    ``(h_seq, h_last)``."""
    _check_backend(backend)
    fn = _scan.rglru_scan if backend == "kernel" else _scan.rglru_scan_plain
    return fn(a, b, h0)
