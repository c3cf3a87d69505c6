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
Rows of the view past the chunk (stale pages) are never read.

Caches are updated in place (the engine owns one cache per wave, and the
paged executor one gathered view per call) and returned.

Cross-attention (:func:`cross_attention_block`) attends every text row to
every image token, unmasked.  It stays torch ops, as it stays XLA in the
reference: the flash kernel takes Sq <= Sk only, and a text prefill is
often longer than the image tokens.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_norm, connective_norm, connective_residual, rope

NEG_INF = -1e30


def _project_qkv(p, x, cfg: ModelConfig):
    """x: (B, S, d) -> q (B, S, H, hd), k and v (B, S, KV, hd)."""
    b, s, d = x.shape
    q = (x @ p["wq"].reshape(d, -1)).view(b, s, cfg.num_heads, cfg.head_dim)
    k = (x @ p["wk"].reshape(d, -1)).view(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = (x @ p["wv"].reshape(d, -1)).view(b, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
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
    ``[offset, offset + S)`` and attends to every position before it.

    The reference's query-chunked prefill attention (``cfg.attn_chunk``,
    its ``_chunked_causal_attention``) only caps the size of its score
    buffer; the flash kernel never holds that buffer, so every prefill
    here, chunked or not, takes the kernel path whatever ``attn_chunk``
    says (it is 0 in every config).
    """
    chunked = mode == "prefill" and cache_index is not None
    if chunked:
        if window > 0:
            raise ValueError("chunked prefill requires full-causal attention")
        if cache is None:
            raise ValueError("chunked prefill needs the gathered cache view")
    xn = connective_norm(x, p["ln1"], cfg.norm)
    q, k, v = _project_qkv(p, xn, cfg)
    b, s = x.shape[:2]

    if cfg.pos_embedding == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if chunked:
        off = int(cache_index)
        k_cache, v_cache = cache["k"], cache["v"]
        k_cache[:, off:off + s] = k
        v_cache[:, off:off + s] = v
        new_cache = {"k": k_cache, "v": v_cache}
        # keys sliced to the chunk's end: the kernel's right-aligned causal
        # mask then puts query j at position off + j
        out = ops.flash_attention(q.transpose(1, 2),
                                  k_cache[:, :off + s].transpose(1, 2),
                                  v_cache[:, :off + s].transpose(1, 2),
                                  causal=True, window=0,
                                  backend=backend).transpose(1, 2)
    elif mode in ("train", "prefill"):
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=True, window=window,
                                  backend=backend).transpose(1, 2)
        if mode == "prefill":
            new_cache = _write_prefill_cache(cache, k, v, window)
    elif mode == "decode":
        k_cache, v_cache = cache["k"], cache["v"]
        cache_len = k_cache.shape[1]
        per_slot = isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1
        if per_slot:
            slot = torch.remainder(cache_index, window) if window > 0 else cache_index
            rows = torch.arange(b, device=x.device)
            k_cache[rows, slot] = k[:, 0]
            v_cache[rows, slot] = v[:, 0]
            idx = cache_index[:, None]
        else:
            idx = int(cache_index)
            slot = idx % window if window > 0 else idx
            k_cache[:, slot:slot + s] = k
            v_cache[:, slot:slot + s] = v
        new_cache = {"k": k_cache, "v": v_cache}
        if window > 0:
            k_pos = _window_cache_positions(idx, window, x.device)
        else:
            span = torch.arange(cache_len, device=x.device)
            k_pos = torch.where(span <= idx, span, -1)
        mask = causal_window_mask(positions, k_pos, window)
        out = _cache_attention(q, k_cache, v_cache, mask)
    else:
        raise ValueError(mode)

    h, hd = cfg.num_heads, cfg.head_dim
    proj = out.reshape(b, s, h * hd) @ p["wo"].reshape(h * hd, -1)
    return connective_residual(x, proj), new_cache


def _write_prefill_cache(cache: Dict, k, v, window: int):
    """Fill the cache from prefill K/V (in place).  Full attention: write
    [0, S).  Sliding window: keep the last W tokens at slots t % W."""
    s = k.shape[1]
    if window > 0 and s > window:
        slots = torch.remainder(torch.arange(s - window, s, device=k.device), window)
        cache["k"][:, slots] = k[:, -window:]
        cache["v"][:, slots] = v[:, -window:]
    else:
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
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
    b, s, d = xn.shape
    h, hd = cfg.num_heads, cfg.head_dim
    q = (xn @ p["wq"].reshape(d, -1)).view(b, s, h, hd)
    if cfg.qkv_bias:
        q = q + p["bq"]
    if mode == "decode":
        k, v = cache["k"], cache["v"]
        new_cache = cache
    else:
        imgs = apply_norm(img_embeds, p["kv_norm"], cfg.norm)
        n = imgs.shape[1]
        k = (imgs @ p["wk"].reshape(d, -1)).view(b, n, cfg.num_kv_heads, hd)
        v = (imgs @ p["wv"].reshape(d, -1)).view(b, n, cfg.num_kv_heads, hd)
        if cfg.qkv_bias:
            k = k + p["bk"]
            v = v + p["bv"]
        new_cache = None
        if mode == "prefill":
            cache["k"].copy_(k)
            cache["v"].copy_(v)
            new_cache = cache
    out = _cache_attention(q, k, v)
    proj = out.reshape(b, s, h * hd) @ p["wo"].reshape(h * hd, -1)
    proj = torch.tanh(p["xgate"].float()).to(proj.dtype) * proj
    return connective_residual(x, proj), new_cache
