"""Dense serving caches of the model zoo: KV caches (full or
sliding-window, and the cross-attention's frozen image K/V of ``(B,
num_image_tokens, kv, hd)``) and recurrent states (RG-LRU, mLSTM,
sLSTM), mirroring the grouped parameter tree (a leading ``num_groups`` dim on ``"groups"``
entries).  Recurrent states are fp32 whatever the model dtype; the
xLSTM stabilizers start at ``m = -1e30`` and the sLSTM normalizer at
``n = 1e-6`` (``_INIT_SPECIAL``), every other leaf at zero.

The same tree is the paged pool of the continuous scheduler:
``make_cache(cfg, num_pages, page_size)`` read as (page, in-page slot),
so every leaf of an attention-only stack is ``(G?, P, page_size, kv,
hd)`` (:func:`cache_page_size`, :func:`map_cache_leaves`)."""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import CACHE_AXES, XCACHE_AXES
from repro_torch.models.rglru import REC_CACHE_AXES
from repro_torch.models.sharding import (Rules, abstract_tensor, fake_mode, from_local,
                                         local_shape_offset)
from repro_torch.models.xlstm import MLSTM_CACHE_AXES, SLSTM_CACHE_AXES, xlstm_dims


def _attn_shapes(cfg: ModelConfig, batch: int, cache_len: int):
    w = cfg.window
    length = w if w > 0 else cache_len  # rolling buffer is always W slots
    shape = (batch, length, cfg.num_kv_heads, cfg.head_dim)
    return {"k": (shape, cfg.dtype), "v": (shape, cfg.dtype)}


def _xattn_shapes(cfg: ModelConfig, batch: int, cache_len: int):
    shape = (batch, cfg.num_image_tokens, cfg.num_kv_heads, cfg.head_dim)
    return {"k": (shape, cfg.dtype), "v": (shape, cfg.dtype)}


def _rec_shapes(cfg: ModelConfig, batch: int, cache_len: int):
    w, cw = cfg.lru_width, cfg.conv_width
    return {"h": ((batch, w), "float32"), "conv": ((batch, cw - 1, w), cfg.dtype)}


def _mlstm_shapes(cfg: ModelConfig, batch: int, cache_len: int):
    _, nh, dh = xlstm_dims(cfg)
    return {"c": ((batch, nh, dh, dh), "float32"), "n": ((batch, nh, dh), "float32"),
            "m": ((batch, nh), "float32")}


def _slstm_shapes(cfg: ModelConfig, batch: int, cache_len: int):
    _, nh, dh = xlstm_dims(cfg)
    return {k: ((batch, nh, dh), "float32") for k in ("h", "c", "n", "m")}


_SHAPES = {"attn": _attn_shapes, "xattn": _xattn_shapes, "rec": _rec_shapes,
           "mlstm": _mlstm_shapes, "slstm": _slstm_shapes}

#: logical axes of each cache leaf, per block kind
_AXES = {"attn": {"k": CACHE_AXES, "v": CACHE_AXES},
         "xattn": {"k": XCACHE_AXES, "v": XCACHE_AXES},
         "rec": REC_CACHE_AXES, "mlstm": MLSTM_CACHE_AXES, "slstm": SLSTM_CACHE_AXES}

_INIT_SPECIAL = {("mlstm", "m"): -1e30, ("slstm", "m"): -1e30, ("slstm", "n"): 1e-6}


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


def make_cache(cfg: ModelConfig, batch: int, cache_len: int, *, device=None,
               abstract: bool = False, rules: Optional[Rules] = None) -> Dict:
    """The fresh cache tree for ``apply_model(mode="prefill"|"decode")``.
    ``abstract=True`` gives fake tensors instead (nothing allocated), as
    the reference's ``ShapeDtypeStruct``s.  Under ``rules`` with a mesh
    each leaf is a ``DTensor`` placed by its logical axes (a grouped
    leaf's group dim replicated); a real one holds this rank's shard
    only.  (The reference leaves its real cache's layout to XLA under the
    jitted step's constraints; a ``DTensor`` needs it stated.)"""
    mesh = None if rules is None else rules.mesh

    def leaf(part, key, name, shape, dt):
        kind = key.split("_", 1)[1]
        axes = tuple(_AXES[kind][name])
        if part == "groups":
            axes = (None,) + axes
        if abstract:
            return abstract_tensor(shape, getattr(torch, dt), rules, axes)
        fill = _INIT_SPECIAL.get((kind, name), 0.0)
        if mesh is None:
            return torch.full(shape, fill, dtype=getattr(torch, dt), device=device)
        placements = rules.placements(rules.spec(axes, shape=shape))
        local = torch.full(local_shape_offset(shape, mesh, placements)[0], fill,
                           dtype=getattr(torch, dt), device=device)
        return from_local(local, mesh, placements, shape)

    def build():
        return {part: {key: {n: leaf(part, key, n, shape, dt)
                             for n, (shape, dt) in leaves.items()}
                       for key, leaves in blocks.items()}
                for part, blocks in cache_shapes(cfg, batch, cache_len).items()}

    if not abstract:
        return build()
    with fake_mode():
        return build()


def reset_cache(tree: Dict) -> None:
    """Fill every leaf of a :func:`make_cache` tree in place with its
    initial value (``_INIT_SPECIAL``'s, else zero): bitwise a fresh cache,
    with every tensor where it was (a wave cache reused by the next wave:
    the RG-LRU prefill starts from ``h``, and a stale non-finite V entry
    would turn masked attention into NaN)."""
    for blocks in tree.values():
        for key, leaves in blocks.items():
            kind = key.split("_", 1)[1]
            for name, t in leaves.items():
                t.fill_(_INIT_SPECIAL.get((kind, name), 0.0))


def cache_page_size(pool: Dict) -> int:
    """Positions per page of a pool built by ``make_cache(cfg, num_pages,
    page_size)``: grouped leaves are (G, P, page, kv, hd), tail leaves (P,
    page, kv, hd)."""
    for part in ("groups", "tail"):
        for leaves in pool[part].values():
            leaf = next(iter(leaves.values()))
            return leaf.shape[2] if part == "groups" else leaf.shape[1]
    raise ValueError("empty cache tree")


def map_cache_leaves(pool: Dict, other: Dict, fn: Callable) -> Dict:
    """``fn(pool_leaf, other_leaf, grouped)`` over an attention-only cache
    tree ({"groups": {...}, "tail": {...}} of {"k", "v"} leaves); grouped
    leaves carry the leading group dim.  This walk owns the schema of
    :func:`make_cache`, so the paged gather and scatter stay layout-blind."""
    out: Dict = {"groups": {}, "tail": {}}
    for part in ("groups", "tail"):
        for key, leaves in pool[part].items():
            out[part][key] = {n: fn(leaf, other[part][key][n], part == "groups")
                              for n, leaf in leaves.items()}
    return out


def cache_bytes(cfg: ModelConfig, batch: int, cache_len: int) -> int:
    """Bytes of :func:`make_cache`'s tree, from its shapes alone."""
    return sum(math.prod(shape) * getattr(torch, dt).itemsize
               for blocks in cache_shapes(cfg, batch, cache_len).values()
               for leaves in blocks.values()
               for shape, dt in leaves.values())
