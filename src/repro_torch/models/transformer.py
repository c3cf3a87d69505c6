"""Model assembly: embeddings -> block groups -> tail blocks -> norm ->
logits.

The reference runs the groups as a ``jax.lax.scan`` over parameters
stacked along a leading group dim; here a Python loop walks the same
stacked tensors group by group (views, no copies).  Remainder layers
(``num_layers % len(pattern)``) run after the groups as "tail" blocks.

Modes: "train" (no cache), "prefill" (fills the cache, or with a
``cache_index`` offset writes one chunk of it), "decode" (one token per
row).  Prefill and decode update the cache of
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
from repro_torch.models.moe import AUX_KEYS, moe_block
from repro_torch.models.params import group_params, padded_vocab
from repro_torch.models.rglru import rglru_block
from repro_torch.models.xlstm import mlstm_block, slstm_block


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
                 positions, cache_index, backend: str, aux: Optional[Dict]):
    if kind == "attn":
        x, new_cache = self_attention_block(
            p, x, cfg, mode=mode, window=cfg.window, cache=cache,
            positions=positions, cache_index=cache_index, backend=backend)
    elif kind == "rec":
        x, new_cache = rglru_block(p, x, cfg, mode=mode, cache=cache, backend=backend)
    elif kind == "mlstm":
        x, new_cache = mlstm_block(p, x, cfg, mode=mode, cache=cache)
    elif kind == "slstm":
        x, new_cache = slstm_block(p, x, cfg, mode=mode, cache=cache)
    else:
        raise ValueError(kind)
    # FFN sub-layer of attention blocks (rec blocks keep Griffin's MLP; the
    # xLSTM blocks hold their projections inside)
    if kind in ("attn", "rec"):
        if cfg.is_moe:
            x, a = moe_block(p, x, cfg)
            if aux is not None:
                for name in AUX_KEYS:
                    aux[name] = aux[name] + a[name]
        elif cfg.d_ff > 0:
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
    aux: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (logits, new_cache).

    tokens: (B, S) int token ids.  cache_index: decode write position, a
    host int or a (B,) tensor of per-slot depths; in prefill, a host int
    offset selects chunked prefill at positions ``offset + arange(S)``
    into the cache view (full-causal attention stacks only).  backend: "kernel" runs
    the flash and scan kernels (their plain versions on CPU tensors),
    "eager" the plain versions on any device.  rows: None for logits of
    every position, (B, S, V); else an int or a (B,) tensor naming one
    row per batch entry, for (B, V) logits of those rows only — the same
    numbers without the (B, S, V) buffer.  aux: a dict that, when given,
    receives the MoE aux values summed over the layers (``moe_lb_loss``,
    ``moe_z_loss``, ``moe_drop_frac``; zeros for a model without experts).
    """
    if cfg.input_mode != "token" or cfg.pos_embedding not in ("rope", "none"):
        raise NotImplementedError(
            f"{cfg.name}: input_mode {cfg.input_mode!r}, pos_embedding "
            f"{cfg.pos_embedding!r}: the zoo has not ported the 'embed' input mode, "
            f"xattn blocks or sinusoidal positions")
    if mode in ("prefill", "decode") and cache is None:
        raise ValueError(f"{mode} needs a cache from serving.kvcache.make_cache")
    if mode == "decode" and cache_index is None:
        raise ValueError("decode mode requires cache_index")
    chunked = mode == "prefill" and cache_index is not None
    if chunked and (cfg.window > 0 or any(k != "attn" for k in cfg.layer_kinds())):
        # checked before any block runs, so no cache is half written
        raise ValueError("chunked prefill requires full-causal attention")
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
    elif chunked:
        positions = (int(cache_index) + torch.arange(seq, device=dev)).expand(bsz, seq)
    else:
        positions = torch.arange(seq, device=dev).expand(bsz, seq)
    if isinstance(cache_index, torch.Tensor):
        cache_index = cache_index.to(dev)

    if aux is not None:
        aux.update({name: torch.zeros((), device=dev) for name in AUX_KEYS})
    kw = dict(mode=mode, positions=positions, cache_index=cache_index, backend=backend,
              aux=aux)
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
