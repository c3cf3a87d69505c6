"""Structural parameter descriptions and their materialization.

The parameter tree is described once as a nested dict of :class:`PSpec`
(shape + initializer), as the reference describes it.  Layers that repeat
are stacked along a leading ``num_groups`` dim under ``"groups"``;
remainder layers sit under ``"tail"``, one entry each.  From the
description come :func:`init_params` (random weights drawn on the device
from a ``torch.Generator``, so no weight passes through the host) and
:func:`params_from_numpy` (the reference's ``init_params`` tree, as numpy
arrays, carried over for the parity tests).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

VOCAB_PAD = 256


@dataclasses.dataclass(frozen=True)
class PSpec:
    shape: Tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones | lru_a
    scale: float = 0.02


def padded_vocab(cfg: ModelConfig) -> int:
    return cfg.padded_vocab(VOCAB_PAD) if cfg.vocab_size >= VOCAB_PAD else cfg.vocab_size


# --- per-block specs ----------------------------------------------------------

def _norm_spec(cfg: ModelConfig) -> Dict[str, PSpec]:
    d = cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"scale": PSpec((d,), "zeros")}
    return {"scale": PSpec((d,), "ones"), "bias": PSpec((d,), "zeros")}


def _mlp_spec(cfg: ModelConfig) -> Dict[str, PSpec]:
    d, ff = cfg.d_model, cfg.d_ff
    out = {"w_up": PSpec((d, ff)), "w_down": PSpec((ff, d))}
    if cfg.activation in ("swiglu", "geglu"):
        out["w_gate"] = PSpec((d, ff))
    return out


def _attn_spec(cfg: ModelConfig) -> Dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p: Dict = {
        "ln1": _norm_spec(cfg),
        "wq": PSpec((d, h, hd)),
        "wk": PSpec((d, kv, hd)),
        "wv": PSpec((d, kv, hd)),
        "wo": PSpec((h, hd, d)),
        "ln2": _norm_spec(cfg),
    }
    if cfg.qkv_bias:
        p["bq"] = PSpec((h, hd), "zeros")
        p["bk"] = PSpec((kv, hd), "zeros")
        p["bv"] = PSpec((kv, hd), "zeros")
    if cfg.d_ff > 0:
        p["mlp"] = _mlp_spec(cfg)
    return p


def _rec_spec(cfg: ModelConfig) -> Dict:
    d, w, cw = cfg.d_model, cfg.lru_width, cfg.conv_width
    p: Dict = {
        "ln1": _norm_spec(cfg),
        "w_in": PSpec((d, w)),
        "w_gate_in": PSpec((d, w)),
        "conv_w": PSpec((cw, w)),
        "conv_b": PSpec((w,), "zeros"),
        # diagonal RG-LRU gates (block-diagonal in Griffin)
        "a_param": PSpec((w,), "lru_a"),
        "gate_a_w": PSpec((w,), "zeros"),
        "gate_a_b": PSpec((w,), "zeros"),
        "gate_x_w": PSpec((w,), "zeros"),
        "gate_x_b": PSpec((w,), "zeros"),
        "w_out": PSpec((w, d)),
        "ln2": _norm_spec(cfg),
    }
    if cfg.d_ff > 0:
        p["mlp"] = _mlp_spec(cfg)
    return p


_BLOCK_SPECS = {"attn": _attn_spec, "rec": _rec_spec}


def model_spec(cfg: ModelConfig) -> Dict:
    """PSpec tree.  ``"groups"`` entries are stacked with a leading
    ``cfg.num_groups`` dim when materialized; ``"tail"`` entries are
    per-layer."""
    d = cfg.d_model
    v = padded_vocab(cfg)
    spec: Dict = {"embed": {}, "groups": {}, "tail": {}, "final_norm": _norm_spec(cfg)}
    if cfg.input_mode == "token":
        spec["embed"]["tok"] = PSpec((v, d), "normal", 0.02)
    if not cfg.tie_embeddings:
        spec["head"] = {"w": PSpec((1, d, v))}
    for i, kind in enumerate(cfg.block_pattern):
        spec["groups"][f"b{i}_{kind}"] = _BLOCK_SPECS[kind](cfg)
    for i, kind in enumerate(cfg.tail_pattern):
        spec["tail"][f"t{i}_{kind}"] = _BLOCK_SPECS[kind](cfg)
    return spec


def _leaves(tree: Dict, path=()):
    """(path, leaf) pairs of a nested dict, in insertion order."""
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, path + (key,))
        else:
            yield path + (key,), val


def _set(tree: Dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _draw(ps: PSpec, shape, generator, device, dtype):
    """One (group slice of a) leaf, drawn in fp32 and cast."""
    if ps.init == "lru_a":
        # Griffin init: decay a in [0.9, 0.999]; a_param = softplus^-1(-log(a) / c)
        u = torch.rand(shape, generator=generator, device=device) * (0.999 - 0.9) + 0.9
        inner = -torch.log(u) / 8.0
        return torch.log(torch.expm1(inner.clamp_min(1e-8))).to(dtype)
    return (torch.randn(shape, generator=generator, device=device) * ps.scale).to(dtype)


def init_params(cfg: ModelConfig, *, generator: torch.Generator, device=None) -> Dict:
    """Random weights in ``cfg.param_dtype``, drawn on ``device`` from
    ``generator`` with the reference's initializers: norms at zero (RMSNorm
    scales by 1 + scale) or one, the fan-in-scaled normal, and ``lru_a``.
    Grouped leaves are drawn one group at a time, so the fp32 draw never
    holds more than one layer's matrix.  The numbers differ from the
    reference's ``jax.random`` streams; the parity tests carry the
    reference's own weights over with :func:`params_from_numpy`."""
    dtype = getattr(torch, cfg.param_dtype)
    out: Dict = {}
    for path, ps in _leaves(model_spec(cfg)):
        grouped = path[0] == "groups"
        shape = ((cfg.num_groups,) if grouped else ()) + ps.shape
        if ps.init in ("zeros", "ones"):
            leaf = torch.full(shape, 1.0 if ps.init == "ones" else 0.0,
                              dtype=dtype, device=device)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            ps = dataclasses.replace(ps, scale=min(ps.scale, 1.0 / math.sqrt(max(fan_in, 1))))
            if grouped:
                leaf = torch.empty(shape, dtype=dtype, device=device)
                for g in range(cfg.num_groups):
                    leaf[g] = _draw(ps, ps.shape, generator, device, dtype)
            else:
                leaf = _draw(ps, shape, generator, device, dtype)
        _set(out, path, leaf)
    return out


def params_from_numpy(tree: Dict, *, device=None) -> Dict:
    """The reference's ``init_params`` tree (leaves as numpy arrays or
    anything ``np.asarray`` takes) -> the same tree of tensors on
    ``device``, each in its own dtype (numpy-side bfloat16 arrives as
    ``torch.bfloat16``)."""
    out: Dict = {}
    for path, leaf in _leaves(tree):
        arr = np.asarray(leaf)
        bf16 = arr.dtype.name == "bfloat16"
        t = torch.from_numpy(np.array(arr, dtype=np.float32 if bf16 else arr.dtype))
        if bf16:
            t = t.to(torch.bfloat16)
        _set(out, path, t.to(device=device))
    return out


def group_params(params: Dict, g: int) -> Dict:
    """Group ``g``'s slice of the stacked ``"groups"`` subtree (views)."""
    return {key: _index(sub, g) for key, sub in params["groups"].items()}


def _index(tree: Dict, g: int) -> Dict:
    return {k: (_index(v, g) if isinstance(v, dict) else v[g]) for k, v in tree.items()}
