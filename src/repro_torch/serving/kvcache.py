"""Dense serving caches of the model zoo: KV caches (full or
sliding-window) and RG-LRU states, mirroring the grouped parameter tree
(a leading ``num_groups`` dim on ``"groups"`` entries)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig


def _attn_shapes(cfg: ModelConfig, batch: int, cache_len: int):
    w = cfg.window
    length = w if w > 0 else cache_len  # rolling buffer is always W slots
    shape = (batch, length, cfg.num_kv_heads, cfg.head_dim)
    return {"k": (shape, cfg.dtype), "v": (shape, cfg.dtype)}


def _rec_shapes(cfg: ModelConfig, batch: int, cache_len: int):
    w, cw = cfg.lru_width, cfg.conv_width
    return {"h": ((batch, w), "float32"), "conv": ((batch, cw - 1, w), cfg.dtype)}


_SHAPES = {"attn": _attn_shapes, "rec": _rec_shapes}


def cache_shapes(cfg: ModelConfig, batch: int, cache_len: int) -> Dict:
    """{"groups": {key: {name: (shape, dtype)}}, "tail": {...}} of
    :func:`make_cache`."""
    g = cfg.num_groups
    out: Dict = {"groups": {}, "tail": {}}
    for i, kind in enumerate(cfg.block_pattern):
        out["groups"][f"b{i}_{kind}"] = {
            n: ((g,) + shape, dt)
            for n, (shape, dt) in _SHAPES[kind](cfg, batch, cache_len).items()}
    for i, kind in enumerate(cfg.tail_pattern):
        out["tail"][f"t{i}_{kind}"] = _SHAPES[kind](cfg, batch, cache_len)
    return out


def make_cache(cfg: ModelConfig, batch: int, cache_len: int, *, device=None) -> Dict:
    """The zeroed cache tree for ``apply_model(mode="prefill"|"decode")``."""
    return {part: {key: {n: torch.zeros(shape, dtype=getattr(torch, dt), device=device)
                         for n, (shape, dt) in leaves.items()}
                   for key, leaves in blocks.items()}
            for part, blocks in cache_shapes(cfg, batch, cache_len).items()}
