"""Flash attention: dense (causal / sliding window, GQA) and ragged over a
``SeqLayout`` padded row order.

:func:`flash_attention` is the model zoo's one-shot prefill attention:
queries right-aligned to the keys, causal and sliding-window masks, GQA
and MQA by head index.  On a CUDA tensor it launches the hand-written
kernel of ``csrc/flash_attention.cu``; on a CPU tensor it runs
:func:`flash_attention_plain`.  It replaces the TPU kernel
``src/repro/kernels/flash_attention.py:flash_attention``.

:class:`FlashAttentionFn` gives it a gradient for training: the forward is
:func:`flash_attention` (the kernel on CUDA tensors), the backward
(:func:`flash_attention_backward`) the gradient XLA derives from the
reference's plain attention, written out in torch ops from the saved q,
k, v and output.  The reference has no backward kernel, so neither does
the port yet.

:func:`ragged_flash_attention` is the prefill self-attention of the
kernel backend: queries and keys sit in a padded ragged order
(``positions[r]`` is the real position of padded row ``r``, -1 for a pad
row), a static map of (q tile, key block) pairs prunes the pairs with no
visible valid pair (:func:`attention_block_map`) and marks those that
need no mask (:func:`ragged_block_kinds`), and head slots ``>=
valid_heads`` are skipped.  Pad query rows and pad heads come out exactly
zero.  On a CUDA tensor it launches the hand-written kernel of
``csrc/ragged_flash_attention.cu``; on a CPU tensor it runs
:func:`ragged_flash_attention_plain`.  It replaces the TPU kernel
``src/repro/kernels/flash_attention.py:ragged_flash_attention``.

Both kernels have two paths, chosen by :func:`attention_path` from the
dtype before the launch and counted in ``.paths``: ``"mma"`` (bf16 and
fp16 on the tensor cores, ``csrc/flash_mma.cuh``) and ``"simt"`` (fp32,
the parity dtype, on the CUDA cores).  The head-dim instantiation
(:func:`head_dim_instance`), the tiles (:func:`attention_tiles`) and the
grid (:func:`attention_grid`) are worked out here too, in pure Python, and
passed to the kernels, which refuse a launch whose instantiation, key-block
size or grid differs from what they build.  :func:`dense_key_blocks` is
the dense kernel's per-tile key range, written out for the tests.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import build

NEG_INF = -1e30

#: the C interfaces' dtype codes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: head-dim instantiations of each kernel and path (a head dim runs the
#: smallest one that holds it, zero-padded)
DENSE_HEAD_DIMS = {"mma": (64, 128, 160, 256), "simt": (64, 128, 256)}
RAGGED_HEAD_DIMS = {"mma": (32, 64, 128), "simt": (32, 64, 128)}
#: (query rows, keys) a block of each path: the dense mma kernel's 4 warps
#: of 16 rows, 32-key blocks at instantiation 256; the ragged mma kernel's
#: 2 warps of 16 rows
DENSE_TILES = {"mma": (64, 64), "simt": (64, 64)}
RAGGED_TILES = {"mma": (32, 64), "simt": (64, 64)}

_DENSE_SIGNATURES = {
    "flash_attention": (ctypes.c_int, [
        *[ctypes.c_int] * 4, *[ctypes.c_void_p] * 5, *[ctypes.c_int] * 8,
        *[ctypes.c_longlong] * 12, ctypes.c_void_p,
    ]),
}
_RAGGED_SIGNATURES = {
    "ragged_flash_attention": (ctypes.c_int, [
        *[ctypes.c_int] * 4, *[ctypes.c_void_p] * 6, *[ctypes.c_int] * 6,
        *[ctypes.c_longlong] * 12, ctypes.c_void_p,
    ]),
}


def attention_path(dtype: torch.dtype, hd: int, *, ragged: bool = False) -> str:
    """The attention kernels' path for this dtype: ``"mma"`` (bf16, fp16:
    the tensor cores) or ``"simt"`` (fp32: CUDA-core FMAs).  A row's
    alignment does not change it: misaligned rows are copied element by
    element inside either kernel.  Raises for a dtype or head dim the
    kernel does not take."""
    dims = RAGGED_HEAD_DIMS if ragged else DENSE_HEAD_DIMS
    if dtype in (torch.bfloat16, torch.float16):
        path = "mma"
    elif dtype == torch.float32:
        path = "simt"
    else:
        raise ValueError(f"{'ragged_' if ragged else ''}flash_attention kernel takes "
                         f"float32/bfloat16/float16, got {dtype}")
    if not 0 < hd <= dims[path][-1]:
        raise ValueError(f"head_dim {hd} > {dims[path][-1]} is not supported")
    return path


def head_dim_instance(hd: int, path: str, *, ragged: bool = False) -> int:
    """The kernel instantiation a head dim runs: the smallest that holds
    it (the columns past ``hd`` are zeros in shared memory)."""
    dims = (RAGGED_HEAD_DIMS if ragged else DENSE_HEAD_DIMS)[path]
    for d in dims:
        if hd <= d:
            return d
    raise ValueError(f"head_dim {hd} > {dims[-1]} is not supported")


def attention_tiles(path: str, hdp: int, *, ragged: bool = False) -> Tuple[int, int]:
    """(query rows, keys) of one block of scores at instantiation ``hdp``."""
    if ragged:
        return RAGGED_TILES[path]
    bq, bk = DENSE_TILES[path]
    return (bq, 32) if path == "mma" and hdp > 160 else (bq, bk)


def attention_grid(b: int, h: int, sq: int, path: str, *,
                   ragged: bool = False) -> Tuple[int, int, int]:
    """The launch grid: (q tiles, head slots, batch) blocks."""
    bq = (RAGGED_TILES if ragged else DENSE_TILES)[path][0]
    return (-(-sq // bq), h, b)


def dense_key_blocks(q_tile: int, sq: int, sk: int, *, causal: bool, window: int,
                     block_q: int, block_k: int) -> range:
    """The key blocks the dense kernel's q tile ``q_tile`` loops over:
    those that intersect the keys visible to some row of the tile,
    [p_lo - window + 1, p_hi] with queries right-aligned to the keys."""
    off = sk - sq
    p_lo = q_tile * block_q + off
    p_hi = min(q_tile * block_q + block_q, sq) - 1 + off
    k_lo = max(0, p_lo - window + 1) if window > 0 else 0
    k_hi = min(sk - 1, p_hi) if causal else sk - 1
    if k_hi < k_lo:
        return range(0)
    return range(k_lo // block_k, k_hi // block_k + 1)


def _probs(qg, k, *, causal: bool, window: int, kv_len=None):
    """fp32 softmax(q k^T / sqrt(hd)) under the dense kernel's mask: q
    grouped (B, Hkv, g, Sq, hd), k (B, Hkv, Sk, hd) -> (B, Hkv, g, Sq,
    Sk), queries right-aligned to the keys, or with ``kv_len`` (B,) to
    batch entry b's first ``kv_len[b]`` keys (the rest masked)."""
    sq, hd = qg.shape[-2:]
    sk = k.shape[2]
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) / hd ** 0.5
    q_pos = torch.arange(sq, device=qg.device)[:, None] + (sk - sq)
    k_pos = torch.arange(sk, device=qg.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=qg.device)
    if kv_len is not None:
        # per batch entry: (B, Sq, Sk)
        n = kv_len.to(qg.device, torch.int64)[:, None, None]
        q_pos = q_pos + (n - sk)
        mask = mask & (k_pos < n)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window > 0:
        mask = mask & (k_pos > q_pos - window)
    if kv_len is not None:
        mask = mask[:, None, None]  # against the grouped (B, Hkv, g, Sq, Sk) scores
    scores = torch.where(mask, scores, torch.full((), NEG_INF, device=qg.device))
    return torch.softmax(scores, dim=-1)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          chunk: int = 0, kv_len=None):
    """Plain PyTorch version of :func:`flash_attention`: fp32 scores,
    softmax and PV over the whole masked score matrix, output in
    ``q.dtype``.  ``chunk > 0`` runs the queries ``chunk`` rows at a
    time against the keys up to the chunk's last position (queries stay
    right-aligned), so the live score buffer is (B, H, chunk, Sk) at most:
    the same numbers, the reference's query-chunked attention (causal
    only; ``chunk`` is ignored otherwise).  ``kv_len`` as the kernel's
    (not with ``chunk``)."""
    b, h, sq, hd = q.shape
    if kv_len is not None and 0 < chunk < sq and causal:
        raise ValueError("kv_len is a serving chunk's key count; it takes no query chunk")
    if 0 < chunk < sq and causal:
        return torch.cat([flash_attention_plain(q[:, :, lo:hi], *_chunk_keys(k, v, hi, sq),
                                                causal=causal, window=window)
                          for lo, hi in _chunks(sq, chunk)], dim=2)
    hkv = k.shape[1]
    p = _probs(q.float().reshape(b, hkv, h // hkv, sq, hd), k, causal=causal, window=window,
               kv_len=kv_len)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return out.reshape(b, h, sq, hd).to(q.dtype)


def _chunks(sq: int, chunk: int):
    """[lo, hi) query ranges of ``chunk`` rows (the last may be short)."""
    return [(lo, min(lo + chunk, sq)) for lo in range(0, sq, chunk)]


def _chunk_keys(k, v, hi: int, sq: int):
    """K and V up to the position of query row ``hi - 1`` (queries
    right-aligned to the keys): the keys a causal chunk ending there can
    see, which keeps that chunk right-aligned."""
    end = hi + k.shape[2] - sq
    return k[:, :, :end], v[:, :, :end]


def flash_attention_backward(q, k, v, out, dout, *, causal: bool = True, window: int = 0,
                             chunk: int = 0):
    """Gradients (dq, dk, dv) of :func:`flash_attention` at (q, k, v) with
    output ``out``, for the output gradient ``dout``, in fp32 torch ops
    and cast to the inputs' dtypes.  P is recomputed from q and k (never
    saved); then dV = P^T dO, dP = dO V^T, dS = P * (dP - rowsum(dO * O)),
    dQ = dS K / sqrt(hd), dK = dS^T Q / sqrt(hd), dK and dV summed over
    the query heads of each KV head.  Holds the (B, H, Sq, Sk) fp32 P and
    dP: quadratic in the sequence, as the reference's XLA gradient is;
    ``chunk > 0`` takes the queries ``chunk`` rows at a time (causal: each
    chunk against the keys up to its last position), so P and dP are
    (B, H, chunk, Sk) at most and dK, dV sum over the chunks in fp32."""
    sq = q.shape[2]
    if 0 < chunk < sq and causal:
        dqs = []
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for lo, hi in _chunks(sq, chunk):
            kc, vc = _chunk_keys(k, v, hi, sq)
            dq_c, dk_c, dv_c = _attention_grads(q[:, :, lo:hi], kc, vc, out[:, :, lo:hi],
                                                dout[:, :, lo:hi], causal=causal,
                                                window=window)
            dqs.append(dq_c.to(q.dtype))
            dk[:, :, :kc.shape[2]] += dk_c
            dv[:, :, :vc.shape[2]] += dv_c
        return torch.cat(dqs, dim=2), dk.to(k.dtype), dv.to(v.dtype)
    dq, dk, dv = _attention_grads(q, k, v, out, dout, causal=causal, window=window)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _attention_grads(q, k, v, out, dout, *, causal: bool, window: int):
    """fp32 (dq, dk, dv) of :func:`flash_attention_backward`."""
    b, h, sq, hd = q.shape
    hkv = k.shape[1]
    g = h // hkv
    qg = q.float().reshape(b, hkv, g, sq, hd)
    kf, vf = k.float(), v.float()
    p = _probs(qg, k, causal=causal, window=window)
    do = dout.float().reshape(b, hkv, g, sq, hd)
    dv = torch.einsum("bkgst,bkgsd->bktd", p, do)
    dp = torch.einsum("bkgsd,bktd->bkgst", do, vf)
    delta = (do * out.float().reshape(b, hkv, g, sq, hd)).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    scale = 1.0 / hd ** 0.5
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, kf) * scale
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, qg) * scale
    return dq.reshape(b, h, sq, hd), dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_attention` with a gradient.  Forward: the kernel on
    CUDA tensors (its plain version on CPU tensors), counted as a launch;
    backward: :func:`flash_attention_backward`, torch ops that launch no
    kernel of this repository.  Saves q, k, v and the output (which the
    output projection keeps alive anyway), never P."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out = flash_attention(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, dout, causal=ctx.causal,
                                              window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, kv_len=None):
    """Dense flash attention with causal and sliding-window masks.

    q: (B, H, Sq, hd); k, v: (B, Hkv, Sk, hd) with H % Hkv == 0 and
    Sq <= Sk, any strides with a unit-stride head dim (the zoo passes
    transposed views of its (B, S, H, hd) projections, so nothing is
    copied).  Query row r sits at position r + Sk - Sq; a key at t is
    visible to a query at p iff t <= p (causal) and t > p - window
    (window > 0).  ``kv_len``: None, or an int32 tensor (B,) on q's
    device with Sq <= kv_len[b] <= Sk: batch entry b then sees only keys
    ``[0, kv_len[b])`` and its query row r sits at ``r + kv_len[b] - Sq``,
    bit for bit the call on keys sliced to ``kv_len[b]``.  The kernel
    reads it on the device and nothing here reads its values, so a
    captured launch serves every chunk offset.  Returns (B, H, Sq, hd) in
    ``q.dtype`` whose memory is laid out (B, Sq, H, hd).
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
    if kv_len is not None and (kv_len.shape != (b,) or kv_len.device != q.device):
        raise ValueError(f"kv_len must be ({b},) on {q.device}, got "
                         f"{tuple(kv_len.shape)} on {kv_len.device}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for {q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel takes float32/bfloat16/float16, "
                         f"got {q.dtype}/{k.dtype}/{v.dtype}")
    path = attention_path(q.dtype, hd)
    hdp = head_dim_instance(hd, path)
    grid = attention_grid(b, h, sq, path)
    bk = attention_tiles(path, hdp)[1]
    if kv_len is not None and (kv_len.dtype != torch.int32 or not kv_len.is_contiguous()):
        raise ValueError("the flash_attention kernel takes kv_len as contiguous int32")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    lib = build.load("flash_attention", _DENSE_SIGNATURES)
    strides = [t.stride(i) for t in (q, k, v, out) for i in (0, 2, 1)]
    err = lib.flash_attention(
        _DTYPES[q.dtype], hdp, grid[0], bk, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), None if kv_len is None else kv_len.data_ptr(), b, h, hkv, sq, sk,
        hd, int(bool(causal)), int(window),
        *strides, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    flash_attention.paths[path] += 1
    return out


flash_attention.launches = 0
flash_attention.paths = {"mma": 0, "simt": 0}


def attention_block_map(positions, block_q: int, block_k: int) -> np.ndarray:
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


def ragged_block_kinds(positions, block_q: int, block_k: int) -> np.ndarray:
    """:func:`attention_block_map` with its live pairs split in two: 0 dead,
    1 live and cut (some (query, key) pair of the block is a pad row, past
    the end, or causally hidden: the kernel masks it), 2 live and whole
    (every query and key valid, every key visible to every query: no
    mask)."""
    pos = np.asarray(positions, int)
    (s,) = pos.shape
    nq, nk = -(-s // block_q), -(-s // block_k)
    qpad = np.full(nq * block_q, -1)
    qpad[:s] = pos
    kpad = np.full(nk * block_k, -1)
    kpad[:s] = pos
    qb, kb = qpad.reshape(nq, block_q), kpad.reshape(nk, block_k)
    whole = ((qb.min(1)[:, None] >= 0) & (kb.min(1)[None, :] >= 0)
             & (kb.max(1)[None, :] <= qb.min(1)[:, None]))
    live = attention_block_map(pos, block_q, block_k)
    return np.where(live > 0, np.where(whole, 2, 1), 0).astype(np.int32)


@functools.lru_cache(maxsize=64)
def _device_layout(pos_bytes: bytes, device: str, block_q: int,
                   block_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Positions and block map of one layout at one tile shape, uploaded
    once and cached."""
    pos = np.frombuffer(pos_bytes, dtype=np.int64)
    kinds = ragged_block_kinds(pos, block_q, block_k)
    return (torch.as_tensor(pos.astype(np.int32), device=device),
            torch.as_tensor(kinds, device=device))


@functools.lru_cache(maxsize=64)
def _cpu_positions(pos_bytes: bytes) -> torch.Tensor:
    """One layout's positions as a CPU tensor, made once (a step that reads
    them builds nothing from host data after its first call, as the
    kernel's cached device layout)."""
    return torch.from_numpy(np.frombuffer(pos_bytes, dtype=np.int64).copy())


def ragged_flash_attention_plain(q, k, v, *, positions, valid_heads=None):
    """Plain PyTorch version of :func:`ragged_flash_attention`, fp32
    softmax with the same masking: pad keys are zeroed before use, a row
    with no visible key (a pad query) outputs 0, pad heads output 0.
    ``positions`` may also be a tensor."""
    b, h, s, hd = q.shape
    g = h // k.shape[1]
    pos = torch.as_tensor(positions, device=q.device)
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
        pos = _cpu_positions(np.ascontiguousarray(positions, dtype=np.int64).tobytes())
        return ragged_flash_attention_plain(q, k, v, positions=pos, valid_heads=valid_heads)
    if q.device.type != "cuda":
        raise ValueError(f"no ragged_flash_attention kernel for {q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"ragged_flash_attention kernel takes float32/bfloat16/float16, "
                         f"got {q.dtype}/{k.dtype}/{v.dtype}")
    path = attention_path(q.dtype, hd, ragged=True)
    hdp = head_dim_instance(hd, path, ragged=True)
    bq, bk = attention_tiles(path, hdp, ragged=True)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    vh = h if valid_heads is None else max(0, min(int(valid_heads), h))
    pos, kinds = _device_layout(
        np.ascontiguousarray(positions, dtype=np.int64).tobytes(), str(q.device), bq, bk)
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    lib = build.load("ragged_flash_attention", _RAGGED_SIGNATURES)
    strides = [t.stride(i) for t in (q, k, v, out) for i in (0, 2, 1)]
    err = lib.ragged_flash_attention(
        _DTYPES[q.dtype], hdp, kinds.shape[0], kinds.shape[1], q.data_ptr(),
        k.data_ptr(), v.data_ptr(), out.data_ptr(), pos.data_ptr(), kinds.data_ptr(),
        b, h, hkv, s, hd, vh, *strides,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "ragged_flash_attention")
    ragged_flash_attention.launches += 1
    ragged_flash_attention.paths[path] += 1
    return out


ragged_flash_attention.launches = 0
ragged_flash_attention.paths = {"mma": 0, "simt": 0}
