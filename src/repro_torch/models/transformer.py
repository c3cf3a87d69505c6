"""Model assembly: embeddings -> block groups -> tail blocks -> norm ->
logits.

The reference runs the groups as a ``jax.lax.scan`` over parameters
stacked along a leading group dim; here a Python loop walks the same
stacked tensors group by group (views, no copies).  Remainder layers
(``num_layers % len(pattern)``) run after the groups as "tail" blocks.

Modes: "train" (no cache), "prefill" (fills the cache), "decode" (one
token per row).  Prefill and decode update the cache of
``serving/kvcache.py:make_cache`` in place and return it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import self_attention_block
from repro_torch.models.layers import apply_norm
from repro_torch.models.mlp import mlp_block
from repro_torch.models.params import group_params, padded_vocab
from repro_torch.models.rglru import rglru_block


def _maybe_cast(tree, cfg: ModelConfig):
    """Weights stored in a lower ``param_dtype`` are cast to the compute
    dtype one group at a time (transient, never resident)."""
    target = getattr(torch, cfg.dtype)
    if cfg.param_dtype == cfg.dtype:
        return tree
    if isinstance(tree, dict):
        return {k: _maybe_cast(v, cfg) for k, v in tree.items()}
    return tree.to(target) if tree.is_floating_point() else tree


def embed_tokens(tok_w, tokens):
    return tok_w[tokens]


def compute_logits(params, cfg: ModelConfig, x):
    """x: (..., d) -> logits (..., V_padded) in the model dtype; the pad
    vocab columns are -1e30."""
    vp = padded_vocab(cfg)
    if cfg.tie_embeddings:
        logits = x @ _maybe_cast(params["embed"]["tok"], cfg).T
    else:
        logits = x @ _maybe_cast(params["head"]["w"], cfg)[0]
    if vp != cfg.vocab_size:
        valid = torch.arange(vp, device=x.device) < cfg.vocab_size
        logits = torch.where(valid, logits,
                             torch.full((), -1e30, dtype=logits.dtype, device=x.device))
    return logits


def _apply_block(kind: str, p: Dict, x, cfg: ModelConfig, *, mode: str, cache,
                 positions, cache_index, backend: str):
    if kind == "attn":
        x, new_cache = self_attention_block(
            p, x, cfg, mode=mode, window=cfg.window, cache=cache,
            positions=positions, cache_index=cache_index, backend=backend)
    elif kind == "rec":
        x, new_cache = rglru_block(p, x, cfg, mode=mode, cache=cache, backend=backend)
    else:
        raise ValueError(kind)
    # FFN sub-layer (rec blocks keep Griffin's MLP)
    if cfg.d_ff > 0:
        x = mlp_block(p, x, cfg)
    return x, new_cache


def _store(dst: Dict, src: Dict) -> None:
    """Write a block's new cache into its place in the model's cache
    (attention caches were already written in place)."""
    for name, t in src.items():
        if t is not dst[name]:
            dst[name].copy_(t)


def apply_model(
    params,
    cfg: ModelConfig,
    *,
    tokens,
    mode: str = "train",
    cache: Optional[Dict] = None,
    cache_index=None,
    backend: str = "kernel",
    rows=None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (logits, new_cache).

    tokens: (B, S) int token ids.  cache_index: decode write position, a
    host int or a (B,) tensor of per-slot depths.  backend: "kernel" runs
    the flash and scan kernels (their plain versions on CPU tensors),
    "eager" the plain versions on any device.  rows: None for logits of
    every position, (B, S, V); else an int or a (B,) tensor naming one
    row per batch entry, for (B, V) logits of those rows only — the same
    numbers without the (B, S, V) buffer.
    """
    if cfg.input_mode != "token":
        raise NotImplementedError(f"input_mode {cfg.input_mode!r} is not ported")
    if cfg.pos_embedding not in ("rope", "none"):
        raise NotImplementedError(
            f"pos_embedding {cfg.pos_embedding!r} is not ported to the zoo")
    if mode in ("prefill", "decode") and cache is None:
        raise ValueError(f"{mode} needs a cache from serving.kvcache.make_cache")
    if mode == "decode" and cache_index is None:
        raise ValueError("decode mode requires cache_index")
    if mode == "prefill" and cache_index is not None:
        raise NotImplementedError(
            "chunked prefill at an offset is not ported yet (ROADMAP queue 1, item 11)")
    dtype = getattr(torch, cfg.dtype)
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.tensor(np.asarray(tokens), dtype=torch.long)
    tokens = tokens.to(params["embed"]["tok"].device).long()
    x = embed_tokens(_maybe_cast(params["embed"]["tok"], cfg), tokens).to(dtype)
    bsz, seq = tokens.shape
    dev = x.device

    if mode == "decode":
        if isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1:
            positions = cache_index.to(dev)[:, None].expand(bsz, seq)
        else:
            positions = torch.full((bsz, seq), int(cache_index), device=dev)
    else:
        positions = torch.arange(seq, device=dev).expand(bsz, seq)
    if isinstance(cache_index, torch.Tensor):
        cache_index = cache_index.to(dev)

    kw = dict(mode=mode, positions=positions, cache_index=cache_index, backend=backend)
    for g in range(cfg.num_groups):
        gparams = _maybe_cast(group_params(params, g), cfg)
        for i, kind in enumerate(cfg.block_pattern):
            key = f"b{i}_{kind}"
            c = None if cache is None else {n: t[g] for n, t in cache["groups"][key].items()}
            x, c_new = _apply_block(kind, gparams[key], x, cfg, cache=c, **kw)
            if c_new is not None:
                _store(c, c_new)
    for i, kind in enumerate(cfg.tail_pattern):
        key = f"t{i}_{kind}"
        c = None if cache is None else cache["tail"][key]
        x, c_new = _apply_block(kind, _maybe_cast(params["tail"][key], cfg), x, cfg,
                                cache=c, **kw)
        if c_new is not None:
            _store(c, c_new)

    if rows is not None:
        if isinstance(rows, torch.Tensor):
            x = x[torch.arange(bsz, device=dev), rows.to(dev)]
        else:
            x = x[:, int(rows)]
    x = apply_norm(x, _maybe_cast(params["final_norm"], cfg), cfg.norm)
    logits = compute_logits(params, cfg, x)
    return logits, (None if mode == "train" else cache)
