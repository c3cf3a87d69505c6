"""Flash attention: dense (causal / sliding window, GQA) and ragged over a
``SeqLayout`` padded row order.

:func:`flash_attention` is the model zoo's one-shot prefill attention:
queries right-aligned to the keys, causal and sliding-window masks, GQA
and MQA by head index.  On a CUDA tensor it launches the hand-written
kernel of ``csrc/flash_attention.cu``; on a CPU tensor it runs
:func:`flash_attention_plain`.  It replaces the TPU kernel
``src/repro/kernels/flash_attention.py:flash_attention``.

:func:`ragged_flash_attention` is the prefill self-attention of the
kernel backend: queries and keys sit in a padded ragged order
(``positions[r]`` is the real position of padded row ``r``, -1 for a pad
row), the static :func:`attention_block_map` prunes (q block, k block)
pairs with no visible valid pair, and head slots ``>= valid_heads`` are
skipped.  Pad query rows and pad heads come out exactly zero.  On a CUDA
tensor it launches the hand-written kernel of
``csrc/ragged_flash_attention.cu``; on a CPU tensor it runs
:func:`ragged_flash_attention_plain`.  It replaces the TPU kernel
``src/repro/kernels/flash_attention.py:ragged_flash_attention``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import build

NEG_INF = -1e30

#: the CUDA kernel's query rows per block and keys per k block
BLOCK_Q, BLOCK_K = 64, 64

_DTYPES = {torch.float32: 0, torch.float16: 1}
_SIGNATURES = {
    "ragged_flash_attention": (ctypes.c_int, [
        ctypes.c_int, *[ctypes.c_void_p] * 6, *[ctypes.c_int] * 6,
        *[ctypes.c_longlong] * 12, ctypes.c_void_p,
    ]),
}


#: dtypes of the dense kernel (its C interface's dtype codes)
_DENSE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the dense kernel's largest head dim
DENSE_HD_MAX = 256
_DENSE_SIGNATURES = {
    "flash_attention": (ctypes.c_int, [
        ctypes.c_int, *[ctypes.c_void_p] * 4, *[ctypes.c_int] * 8,
        *[ctypes.c_longlong] * 12, ctypes.c_void_p,
    ]),
}


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """Plain PyTorch version of :func:`flash_attention`: fp32 scores,
    softmax and PV over the whole masked score matrix, output in
    ``q.dtype``."""
    b, h, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.float().reshape(b, hkv, g, sq, hd)
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) / hd ** 0.5
    q_pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    scores = torch.where(mask, scores, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return out.reshape(b, h, sq, hd).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Dense flash attention with causal and sliding-window masks.

    q: (B, H, Sq, hd); k, v: (B, Hkv, Sk, hd) with H % Hkv == 0 and
    Sq <= Sk, any strides with a unit-stride head dim (the zoo passes
    transposed views of its (B, S, H, hd) projections, so nothing is
    copied).  Query row r sits at position r + Sk - Sq; a key at t is
    visible to a query at p iff t <= p (causal) and t > p - window
    (window > 0).  Returns (B, H, Sq, hd) in ``q.dtype`` whose memory is
    laid out (B, Sq, H, hd).
    """
    b, h, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, sk, hd) or v.shape != k.shape or hkv == 0 or h % hkv:
        raise ValueError(f"attention shapes differ: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if sq > sk:
        raise ValueError(f"{sq} queries right-aligned to {sk} keys: need Sq <= Sk")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for {q.device}")
    if q.dtype not in _DENSE_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel takes float32/bfloat16/float16, "
                         f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if hd > DENSE_HD_MAX:
        raise ValueError(f"head_dim {hd} > {DENSE_HD_MAX} is not supported")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    lib = build.load("flash_attention", _DENSE_SIGNATURES)
    strides = [t.stride(i) for t in (q, k, v, out) for i in (0, 2, 1)]
    err = lib.flash_attention(
        _DENSE_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, h, hkv, sq, sk, hd, int(bool(causal)), int(window),
        *strides, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def attention_block_map(positions, block_q: int = BLOCK_Q,
                        block_k: int = BLOCK_K) -> np.ndarray:
    """Static (ceil(S/block_q), ceil(S/block_k)) skip map of a ragged
    causal attention.

    A (q block, k block) pair is live iff some valid key in the k block is
    causally visible to some valid query in the q block; rows past the end
    of a partial last block count as pad.  For a dense ``arange`` layout
    this is the standard causal block skip.
    """
    pos = np.asarray(positions, int)
    (s,) = pos.shape
    nq, nk = -(-s // block_q), -(-s // block_k)
    qpad = np.full(nq * block_q, -1)
    qpad[:s] = pos
    kpad = np.full(nk * block_k, -1)
    kpad[:s] = pos
    qmax = qpad.reshape(nq, block_q).max(1)  # -1 when the block is all pad
    big = np.iinfo(np.int64).max
    kmin = np.where(kpad >= 0, kpad, big).reshape(nk, block_k).min(1)
    live = (qmax[:, None] >= 0) & (kmin[None, :] <= qmax[:, None])
    return live.astype(np.int32)


@functools.lru_cache(maxsize=64)
def _device_layout(pos_bytes: bytes, device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Positions and live map of one layout, uploaded once and cached."""
    pos = np.frombuffer(pos_bytes, dtype=np.int64)
    bm = attention_block_map(pos)
    return (torch.as_tensor(pos.astype(np.int32), device=device),
            torch.as_tensor(bm, device=device))


def ragged_flash_attention_plain(q, k, v, *, positions, valid_heads=None):
    """Plain PyTorch version of :func:`ragged_flash_attention`, fp32
    softmax with the same masking: pad keys are zeroed before use, a row
    with no visible key (a pad query) outputs 0, pad heads output 0."""
    b, h, s, hd = q.shape
    g = h // k.shape[1]
    pos = torch.as_tensor(np.asarray(positions), device=q.device)
    valid = pos >= 0
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    kf = torch.where(valid[:, None], k.float(), zero).repeat_interleave(g, dim=1)
    vf = torch.where(valid[:, None], v.float(), zero).repeat_interleave(g, dim=1)
    scores = (q.float() @ kf.transpose(-1, -2)) * (1.0 / hd ** 0.5)
    mask = valid[:, None] & valid[None, :] & (pos[None, :] <= pos[:, None])
    scores = torch.where(mask, scores, torch.full((), NEG_INF, device=q.device))
    m = scores.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), zero)
    out = (p @ vf) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    vh = h if valid_heads is None else int(valid_heads)
    heads = torch.arange(h, device=q.device) < vh
    return torch.where(heads[:, None, None], out, zero).to(q.dtype)


def ragged_flash_attention(q, k, v, *, positions, valid_heads=None):
    """Causal flash attention over a padded ragged row order.

    q: (B, H, S, hd); k, v: (B, Hkv, S, hd), any strides with a unit-stride
    head dim (the executor passes transposed views of its (B, S, H, hd)
    tensors, so nothing is copied); positions: (S,) static ints, row ->
    real position, -1 = pad row; valid_heads: leading real head slots (host
    int).  Returns (B, H, S, hd) whose memory is laid out (B, S, H, hd).
    Valid rows match ``flash_attention_ref`` over the compacted sequence.
    """
    b, h, s, hd = q.shape
    hkv = k.shape[1]
    if k.shape != (b, hkv, s, hd) or v.shape != k.shape or h % hkv:
        raise ValueError(f"attention shapes differ: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if np.asarray(positions).shape != (s,):
        raise ValueError(f"positions must have {s} rows")
    if q.device.type == "cpu":
        return ragged_flash_attention_plain(q, k, v, positions=positions,
                                            valid_heads=valid_heads)
    if q.device.type != "cuda":
        raise ValueError(f"no ragged_flash_attention kernel for {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"ragged_flash_attention kernel takes float32/float16, "
                         f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if hd > 128:
        raise ValueError(f"head_dim {hd} > 128 is not supported")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    vh = h if valid_heads is None else max(0, min(int(valid_heads), h))
    pos, block_map = _device_layout(
        np.ascontiguousarray(positions, dtype=np.int64).tobytes(), str(q.device))
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    lib = build.load("ragged_flash_attention", _SIGNATURES)
    strides = [t.stride(i) for t in (q, k, v, out) for i in (0, 2, 1)]
    err = lib.ragged_flash_attention(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), pos.data_ptr(), block_map.data_ptr(),
        b, h, hkv, s, hd, vh, *strides,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "ragged_flash_attention")
    ragged_flash_attention.launches += 1
    return out


ragged_flash_attention.launches = 0
