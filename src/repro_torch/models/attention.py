"""Attention blocks: GQA/MQA self-attention (rope, full-causal or
sliding-window, with a KV cache for serving) and cross-attention to image
embeddings (the VLM's image layers).

One-shot prefill (and train) attention runs the dense flash kernel
(``kernels/flash_attention.py``) on (B, H, S, hd) views of the
projections, so MQA's single KV head is read by every query head without
a repeat.  The decode step attends to the cache in torch ops, as the
reference leaves it to XLA: a rolling buffer of W slots under a sliding
window, a position-addressed buffer otherwise.

Chunked prefill at an offset (the paged serving path: prefill chunks and
prefix-hit suffixes) writes the chunk's K/V at ``[offset, offset + S)`` of
the gathered cache view and runs the same flash kernel over keys ``[0,
offset + S)``: the kernel right-aligns the queries to the keys, so chunk
row ``j`` sits at position ``offset + j``, which is the reference's mask.
Rows of the view past the chunk (stale pages) are never read.  With the
offset a host int the keys are sliced there; with a 0-dim tensor on the
device (one process) the kernel takes the whole view and its ``kv_len``,
offset + S, and reads the cut on the device, so one captured program
serves every offset, as the reference's traced scalar does.

Caches are updated in place (the engine owns one cache per wave, and the
paged executor one gathered view per call) and returned.

Cross-attention (:func:`cross_attention_block`) attends every text row to
every image token, unmasked.  It stays torch ops, as it stays XLA in the
reference: the flash kernel takes Sq <= Sk only, and a text prefill is
often longer than the image tokens.

Under a mesh (``models/sharding.py``) this is the paper's MHA block: TP
splits the heads (wq/wk/wv column-split, wo row-split), so attention
itself needs no sync (§III-B-1); it is entered by an AllGather from the
seq-sharded connective block and left by a ReduceScatter.  Where the query
heads do not divide the model axis (24 heads on 16), queries stay
seq-sharded against gathered K/V instead (the SP pattern of §II-C-2).
KV heads are repeated to the query heads there so every attention op is
sharded along heads, and the cache writes go to each chip's own shard
(``sharding.write_rows``).  Under a mesh, or while a dry run counts the
step (``roofline/counter.py``), attention runs as
:class:`_LocalAttentionFn` on each chip's shards: the flash kernel on the
kernel backend, the plain attention on the eager one, counted as the
attention function rather than as its plain ops.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_norm, connective_norm, connective_residual, rope
from repro_torch.models.sharding import (constrain, from_local, local_shape_offset,
                                         logical_axis_size, matmul, mesh_active, project,
                                         put_pairs, write_rows)
from repro_torch.roofline import counter

NEG_INF = -1e30

CACHE_AXES = ("batch", "kv_seq", "kv_heads", None)
XCACHE_AXES = ("batch", "img_seq", "kv_heads", None)


def _heads_shardable(cfg: ModelConfig) -> bool:
    """True if the query heads divide the model axis: the paper's head-wise
    TP (§III-B-1).  Otherwise attention falls back to the SP layout
    (seq-sharded queries, gathered K/V), which 24-head archs take on the
    16-way mesh."""
    ax = logical_axis_size("heads")
    return ax <= 1 or cfg.num_heads % ax == 0


def _q_axes(cfg: ModelConfig):
    if _heads_shardable(cfg):
        return ("batch", None, "heads", None)
    return ("batch", "seq", None, None)  # SP-attention fallback


def _expand_kv(x, cfg: ModelConfig):
    """Under a mesh with head-sharded queries, K/V (B, L, KV, hd) repeated
    to the query heads and sharded along them (replicated KV and a local
    repeat: no collective); the ``kv_seq`` name stays, so a seq-sharded
    cache keeps its layout.  Anywhere else ``x`` as it is: the kernels
    take GQA natively."""
    if not mesh_active() or not _heads_shardable(cfg):
        return x
    g = cfg.num_heads // x.shape[2]
    if g > 1:
        x = torch.repeat_interleave(x, g, dim=2)
    return constrain(x, ("batch", "kv_seq", "heads", None))


def _heads(x, w, n, hd, names):
    """x (B, S, d) @ w (d, n, hd) viewed as (B, S, n, hd); under a mesh laid
    out by ``names`` (``sharding.project``)."""
    b, s, d = x.shape
    return project(x, w.reshape(d, -1), names, (b, s, n, hd)).view(b, s, n, hd)


def _project_qkv(p, x, cfg: ModelConfig):
    """x: (B, S, d) -> q (B, S, H, hd), k and v (B, S, KV, hd)."""
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kv_axes = ("batch", None, "kv_heads", None)
    q = _heads(x, p["wq"], h, hd, _q_axes(cfg))
    k = _heads(x, p["wk"], kv, hd, kv_axes)
    v = _heads(x, p["wv"], kv, hd, kv_axes)
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = constrain(q, _q_axes(cfg))
    k = constrain(k, kv_axes)
    v = constrain(v, kv_axes)
    return q, k, v


def causal_window_mask(q_pos, k_pos, window: int):
    """q_pos: (B, S), k_pos: (B, L) or (L,) -> bool (B, 1, S, L).  A key
    at a negative position is an empty cache slot."""
    if k_pos.dim() == 1:
        k_pos = k_pos[None, :]
    m = k_pos[:, None, :] <= q_pos[:, :, None]
    if window > 0:
        m = m & (k_pos[:, None, :] > q_pos[:, :, None] - window)
    m = m & (k_pos[:, None, :] >= 0)
    return m[:, None, :, :]


def _window_cache_positions(cache_index, window: int, device):
    """Token position held in each rolling-buffer slot after the write at
    ``cache_index``: slot s holds t = idx - ((idx - s) mod W); t < 0 is
    empty (-1)."""
    slots = torch.arange(window, device=device)
    t = cache_index - torch.remainder(cache_index - slots, window)
    return torch.where(t >= 0, t, -1)


def _cache_attention(q, k_cache, v_cache, mask=None):
    """Attention in torch ops against a cache (decode) or the image K/V
    (cross-attention).  q: (B, S, H, hd); k/v (B, L, KV, hd); mask (B, 1,
    S, L), or None for none.  Scores in the model dtype, softmax in fp32,
    probabilities cast to ``v``'s dtype before PV, as the reference."""
    b, s, h, hd = q.shape
    kv = k_cache.shape[2]
    qg = q.reshape(b, s, kv, h // kv, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k_cache) / math.sqrt(hd)
    scores = scores.float()
    if mask is not None:
        scores = torch.where(mask[:, :, None], scores, torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v_cache)
    return out.reshape(b, s, h, hd)


def _decode_attention(q, k_cache, v_cache, mask):
    """:func:`_cache_attention` of a decode step.  Under a mesh with
    head-sharded queries and a cache whole along its positions, each chip
    attends its own query heads to the KV heads they read, on its local
    shards (no collective): ``DTensor`` cannot always split the grouped
    product's merged dims (torch 2.11 refuses)."""
    from torch.distributed.tensor import DTensor, Shard

    if (not isinstance(q, DTensor) or Shard(2) not in q.placements
            or Shard(1) in k_cache.placements):
        return _cache_attention(q, k_cache, v_cache, mask)
    ql, kl, vl = q.to_local(), k_cache.to_local(), v_cache.to_local()
    if Shard(2) not in k_cache.placements:
        # every KV head is here: keep those this chip's query heads read
        g = q.shape[2] // k_cache.shape[2]
        off, hl = local_shape_offset(q.shape, q.device_mesh, q.placements)[1][2], ql.shape[2]
        if not ((off % g == 0 and hl % g == 0) or (g % hl == 0 and off % hl == 0)):
            raise ValueError(f"{hl} query heads at {off} do not group onto {g}-head KV groups")
        kl, vl = (t[:, :, off // g:(off + hl - 1) // g + 1] for t in (kl, vl))
    out = _cache_attention(ql, kl, vl, mask.to_local() if isinstance(mask, DTensor) else mask)
    return from_local(out, q.device_mesh, q.placements, q.shape)


def _attention(q, k, v, *, causal: bool, window: int, backend: str, chunk: int = 0,
               kv_len=None):
    """Attention on (B, H, S, hd) views: ``ops.flash_attention``, or under a
    mesh (either backend), a dry-run counter or a query ``chunk`` on the
    eager backend, attention on local shards (:class:`_LocalAttentionFn`:
    the flash kernel on each rank's shards on the kernel backend, the plain
    attention on the eager one).  ``kv_len`` (a chunk at a device offset,
    one process) goes to ``ops.flash_attention``."""
    if kv_len is not None:
        if mesh_active():
            raise ValueError("a chunk at a device offset runs on one process; under "
                             "the sharding rules the offset is a host int")
        return ops.flash_attention(q, k, v, causal=causal, window=window, backend=backend,
                                   kv_len=kv_len)
    if mesh_active() or (backend == "eager" and (chunk or counter.active() is not None)):
        from torch.distributed.tensor import DTensor

        if isinstance(q, DTensor):
            k, v = _align_kv(q, k), _align_kv(q, v)
        return _LocalAttentionFn.apply(q, k, v, causal, window,
                                       chunk if backend == "eager" else 0, backend)
    return ops.flash_attention(q, k, v, causal=causal, window=window, backend=backend)


def _align_kv(q, t):
    """K or V laid out as the queries on the batch and head dims, whole
    along the keys, so each chip attends its own queries locally.  KV heads
    that stay whole where the query heads split (a chunk's cache view with
    fewer KV heads than chips) are first repeated to the query heads, a
    local copy of whole K/V, as the one-shot path's ``_expand_kv``."""
    from torch.distributed.tensor import Replicate, Shard

    want = tuple(p if isinstance(p, Shard) and p.dim in (0, 1) else Replicate()
                 for p in q.placements)
    if (Shard(1) in want and Shard(1) not in t.placements
            and t.shape[1] != q.shape[1]):
        t = torch.repeat_interleave(t, q.shape[1] // t.shape[1], dim=1)
    return t if tuple(t.placements) == want else t.redistribute(t.device_mesh, want)


class _LocalAttentionFn(torch.autograd.Function):
    """Attention and its torch-ops gradient (``flash_attention_backward``)
    on local shards (``DTensor`` inputs) or on whole tensors: on the
    ``"kernel"`` backend the forward launches ``ops.flash_attention`` on
    the local shards, on ``"eager"`` it runs the plain version.  Queries
    sharded along the sequence see the keys up to their own last position:
    the plain version right-aligns its queries to its keys, so the keys are
    cut there (the rest are masked anyway), and the K/V gradients are
    partial sums over the query shards.

    ``chunk > 0`` is the reference's query-chunked attention
    (``_chunked_causal_attention``): the queries go ``chunk`` rows at a
    time, forward and backward, so the score buffers are (B, H, chunk, S)
    where the whole attention's are (B, H, S, S).  On queries sharded
    along the sequence a chip takes its share of each chunk's rows
    (``chunk`` x local rows / all rows), as the chunk's buffer would be
    laid out over the chips."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, chunk: int = 0,
                backend: str = "eager"):
        from torch.distributed.tensor import DTensor

        ctx.dist = isinstance(q, DTensor)
        ql, kl, vl = (counter.local(t) for t in (q, k, v))
        sk = k.shape[2]
        if ctx.dist and causal:
            q_off = local_shape_offset(q.shape, q.device_mesh, q.placements)[1][2]
            sk = q_off + ql.shape[2] + k.shape[2] - q.shape[2]
        kl, vl = kl[:, :, :sk], vl[:, :, :sk]
        if chunk:
            chunk = max(1, chunk * ql.shape[2] // q.shape[2])
        ctx.chunk = chunk
        # the counts split the whole attention's work evenly over the chips
        ctx.bwd_cost = counter.attention_cost(q, k, v, q, causal=causal, window=window,
                                              backward=True)
        with counter.function(*counter.attention_cost(q, k, v, q, causal=causal,
                                                      window=window)):
            if backend == "kernel":
                out = ops.flash_attention(ql, kl, vl, causal=causal, window=window)
            else:
                out = _flash.flash_attention_plain(ql, kl, vl, causal=causal, window=window,
                                                   chunk=chunk)
            # laid out (B, Sq, H, hd) in memory, as the kernel writes it
            out = out.transpose(1, 2).contiguous().transpose(1, 2)
        ctx.save_for_backward(ql, kl, vl, out)
        ctx.causal, ctx.window, ctx.sk = causal, window, k.shape[2]
        if not ctx.dist:
            return out
        ctx.q_meta = (q.device_mesh, q.placements)
        ctx.k_pl = k.placements
        b, h, sq, hd = q.shape
        return DTensor.from_local(out, q.device_mesh, q.placements, run_check=False,
                                  shape=q.shape, stride=(sq * h * hd, hd, h * hd, 1))

    @staticmethod
    def backward(ctx, dout):
        from torch.distributed.tensor import DTensor, Partial, Shard

        ql, kl, vl, out = ctx.saved_tensors
        if ctx.dist:
            mesh, q_pl = ctx.q_meta
            dout = dout.redistribute(mesh, q_pl).to_local()
        with counter.function(*ctx.bwd_cost):
            dq, dk, dv = _flash.flash_attention_backward(ql, kl, vl, out, dout,
                                                         causal=ctx.causal, window=ctx.window,
                                                         chunk=ctx.chunk)
        if dk.shape[2] < ctx.sk:
            pad = ctx.sk - dk.shape[2]
            dk = torch.cat([dk, dk.new_zeros(dk.shape[:2] + (pad,) + dk.shape[3:])], dim=2)
            dv = torch.cat([dv, dv.new_zeros(dv.shape[:2] + (pad,) + dv.shape[3:])], dim=2)
        if not ctx.dist:
            return dq, dk, dv, None, None, None, None
        # K/V met only this chip's queries: their gradients sum over the query shards
        kv_pl = tuple(Partial() if isinstance(qp, Shard) and qp.dim == 2 else kp
                      for qp, kp in zip(q_pl, ctx.k_pl))
        # (global strides follow the local tensors' own layouts)
        return (DTensor.from_local(dq, mesh, q_pl, run_check=False),
                DTensor.from_local(dk, mesh, kv_pl, run_check=False),
                DTensor.from_local(dv, mesh, kv_pl, run_check=False), None, None, None, None)


def self_attention_block(
    p: Dict,
    x,
    cfg: ModelConfig,
    *,
    mode: str,
    window: int,
    cache: Optional[Dict],
    positions,
    cache_index=None,
    backend: str = "kernel",
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One attention sub-layer (norm -> attn -> residual).  Returns
    (x, new_cache).

    mode: "train" | "prefill" | "decode".  window: 0 for full causal, > 0
    for a sliding window (rolling cache of W slots).  positions: (B, S)
    absolute token positions (rope and the decode mask); one-shot prefill
    and train take them to be ``arange(S)``.  cache_index: the decode
    write position, a host int (lockstep batch) or a (B,) tensor of
    per-slot depths.  In prefill, None is the one-shot path and a host
    int ``offset`` selects chunked prefill: the chunk is written at
    ``[offset, offset + S)`` and attends to every position before it; a
    0-dim tensor ``offset`` on the device does the same over the whole
    cache view, reading nothing on the host (one process, no mesh).

    ``cfg.attn_chunk`` (train and one-shot prefill of more than
    ``attn_chunk`` rows, a multiple of it) is the reference's query-chunked
    attention (``_chunked_causal_attention``): on the eager backend the
    queries go ``attn_chunk`` rows at a time, so the score buffer is (B, H,
    chunk, S), not (B, H, S, S), which the dry run's peak memory sees.
    The kernel backend keeps the flash kernel, which never holds that
    buffer.
    """
    chunked = mode == "prefill" and cache_index is not None
    if chunked:
        if window > 0:
            raise ValueError("chunked prefill requires full-causal attention")
        if cache is None:
            raise ValueError("chunked prefill needs the gathered cache view")
    xn = connective_norm(x, p["ln1"], cfg.norm)
    xg = constrain(xn, ("batch", None, "embed"))  # AllGather: enter the TP block
    q, k, v = _project_qkv(p, xg, cfg)
    b, s = x.shape[:2]

    if cfg.pos_embedding == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if chunked and isinstance(cache_index, torch.Tensor):
        # the offset on the device (one captured program for every offset):
        # the chunk's K/V land at positions offset + arange(S) of the whole
        # view, and the kernel reads each row's key count, offset + S, on
        # the device: query j at position offset + j, keys past the chunk
        # unseen, the numbers of the sliced call below
        k_cache, v_cache = cache["k"], cache["v"]
        pos = cache_index + torch.arange(s, device=x.device)
        k_cache.index_copy_(1, pos, k)
        v_cache.index_copy_(1, pos, v)
        new_cache = {"k": k_cache, "v": v_cache}
        kv_len = (cache_index + s).to(torch.int32).reshape(1).expand(b).contiguous()
        out = _attention(q.transpose(1, 2), k_cache.transpose(1, 2),
                         v_cache.transpose(1, 2), causal=True, window=0,
                         backend=backend, kv_len=kv_len).transpose(1, 2)
    elif chunked:
        off = int(cache_index)
        k_cache, v_cache = cache["k"], cache["v"]
        write_rows(k_cache, k, 1, off)
        write_rows(v_cache, v, 1, off)
        new_cache = {"k": k_cache, "v": v_cache}
        # keys sliced to the chunk's end: the kernel's right-aligned causal
        # mask then puts query j at position off + j
        out = _attention(q.transpose(1, 2), k_cache[:, :off + s].transpose(1, 2),
                         v_cache[:, :off + s].transpose(1, 2), causal=True, window=0,
                         backend=backend).transpose(1, 2)
    elif mode in ("train", "prefill"):
        chunk = cfg.attn_chunk if 0 < cfg.attn_chunk < s else 0
        if chunk and s % chunk:
            raise ValueError(f"attn_chunk {chunk} must divide the sequence, {s}")
        out = _attention(q.transpose(1, 2), _expand_kv(k, cfg).transpose(1, 2),
                         _expand_kv(v, cfg).transpose(1, 2), causal=True, window=window,
                         backend=backend, chunk=chunk).transpose(1, 2)
        if mode == "prefill":
            new_cache = _write_prefill_cache(cache, k, v, window)
    elif mode == "decode":
        k_cache, v_cache = cache["k"], cache["v"]
        cache_len = k_cache.shape[1]
        per_slot = isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1
        if per_slot:
            # each row at its own depth (under a mesh on each rank's shard)
            slot = torch.remainder(cache_index, window) if window > 0 else cache_index
            rows = torch.arange(b, device=x.device)
            put_pairs(k_cache, 0, rows, slot, k[:, 0])
            put_pairs(v_cache, 0, rows, slot, v[:, 0])
            idx = cache_index[:, None]
        else:
            idx = int(cache_index)
            slot = idx % window if window > 0 else idx
            write_rows(k_cache, k, 1, slot)
            write_rows(v_cache, v, 1, slot)
        new_cache = {"k": constrain(k_cache, CACHE_AXES), "v": constrain(v_cache, CACHE_AXES)}
        if window > 0:
            k_pos = _window_cache_positions(idx, window, x.device)
        else:
            span = torch.arange(cache_len, device=x.device)
            k_pos = torch.where(span <= idx, span, -1)
        mask = causal_window_mask(positions, k_pos, window)
        out = _decode_attention(q, k_cache, v_cache, mask)
    else:
        raise ValueError(mode)

    h, hd = cfg.num_heads, cfg.head_dim
    proj = matmul(out.reshape(b, s, h * hd), p["wo"].reshape(h * hd, -1))
    return connective_residual(x, proj), new_cache


def _write_prefill_cache(cache: Dict, k, v, window: int):
    """Fill the cache from prefill K/V (in place).  Full attention: write
    [0, S).  Sliding window: keep the last W tokens at slots t % W."""
    s = k.shape[1]
    if window > 0 and s > window:
        # the last W tokens at slots t % W are the last W rolled by (s - W) % W,
        # as two slices joined (a roll has no DTensor sharding rule in torch 2.11)
        r = (s - window) % window
        k, v = (torch.cat([t[:, s - r:], t[:, s - window:s - r]], dim=1) for t in (k, v))
    write_rows(cache["k"], k, 1, 0)
    write_rows(cache["v"], v, 1, 0)
    return cache


def cross_attention_block(p: Dict, x, cfg: ModelConfig, *, mode: str, img_embeds,
                          cache: Optional[Dict]) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Cross-attention to the (stubbed) vision patch embeddings: norm ->
    q from the text, K/V from ``kv_norm(img_embeds)`` -> full softmax ->
    out-projection gated by ``tanh(xgate)`` -> residual.  Returns (x,
    new_cache).

    The image K/V are computed once, in train and prefill; prefill writes
    them into the cache (in place, ``(B, num_image_tokens, kv, hd)``) and
    decode reads them back frozen.  ``img_embeds``: (B, I, d) in the model
    dtype; unused in decode."""
    xn = connective_norm(x, p["ln1"], cfg.norm)
    xg = constrain(xn, ("batch", None, "embed"))
    b, s, d = xn.shape
    h, hd = cfg.num_heads, cfg.head_dim
    q = _heads(xg, p["wq"], h, hd, ("batch", None, "heads", None))
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = constrain(q, ("batch", None, "heads", None))
    if mode == "decode":
        k, v = cache["k"], cache["v"]
        new_cache = cache
    else:
        imgs = apply_norm(img_embeds, p["kv_norm"], cfg.norm)
        n = imgs.shape[1]
        k = _heads(imgs, p["wk"], cfg.num_kv_heads, hd, XCACHE_AXES)
        v = _heads(imgs, p["wv"], cfg.num_kv_heads, hd, XCACHE_AXES)
        if cfg.qkv_bias:
            k = k + p["bk"]
            v = v + p["bv"]
        k = constrain(k, XCACHE_AXES)
        v = constrain(v, XCACHE_AXES)
        new_cache = None
        if mode == "prefill":
            cache["k"].copy_(k)
            cache["v"].copy_(v)
            new_cache = cache
    if mesh_active():
        # each chip attends its own queries to the image K/V (no merged
        # batch and head dims, which the sharding propagation cannot split)
        out = _attention(q.transpose(1, 2), _expand_kv(k, cfg).transpose(1, 2),
                         _expand_kv(v, cfg).transpose(1, 2), causal=False, window=0,
                         backend="eager").transpose(1, 2)
    else:
        out = _cache_attention(q, k, v)
    proj = matmul(out.reshape(b, s, h * hd), p["wo"].reshape(h * hd, -1))
    proj = torch.tanh(p["xgate"].float()).to(proj.dtype) * proj
    return connective_residual(x, proj), new_cache
