"""RG-LRU sequence scan: h_t = a_t * h_{t-1} + b_t along the sequence.

:func:`rglru_scan` is RecurrentGemma's recurrence over a prefill: per
(batch, width column) a sequential loop over S carrying h in fp32.  On a
CUDA tensor it launches the hand-written kernel of ``csrc/rglru_scan.cu``;
on a CPU tensor it runs :func:`rglru_scan_plain`.  It replaces the TPU
kernel ``src/repro/kernels/rglru_scan.py:rglru_scan_kernel``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SIGNATURES = {
    "rglru_scan": (ctypes.c_int, [
        ctypes.c_int, *[ctypes.c_void_p] * 5, *[ctypes.c_int] * 3,
        ctypes.c_void_p,
    ]),
}


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
    lib = build.load("rglru_scan", _SIGNATURES)
    err = lib.rglru_scan(
        _DTYPES[a.dtype], a.data_ptr(), b.data_ptr(), h0.data_ptr(),
        h_seq.data_ptr(), h_last.data_ptr(), bsz, s, w,
        torch.cuda.current_stream(a.device).cuda_stream)
    build.check(err, "rglru_scan")
    rglru_scan.launches += 1
    return h_seq, h_last


rglru_scan.launches = 0
