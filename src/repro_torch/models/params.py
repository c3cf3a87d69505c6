"""Structural parameter descriptions and their materialization.

The parameter tree is described once as a nested dict of :class:`PSpec`
(shape + logical axes + initializer), as the reference describes it.  Layers that repeat
are stacked along a leading ``num_groups`` dim under ``"groups"``;
remainder layers sit under ``"tail"``, one entry each.  From the
description come :func:`init_params` (random weights drawn on the device
from a ``torch.Generator``, so no weight passes through the host) and
:func:`params_from_numpy` (the reference's ``init_params`` tree, as numpy
arrays, carried over for the parity tests), and for the multi-chip dry
run :func:`abstract_params` (fake tensors, nothing allocated) and
:func:`partition_specs` (each leaf's mesh axes under a rules table).
Under rules with a real mesh, ``init_params(rules=)`` and
:func:`place_params` give the tree as ``DTensor``s, each rank holding its
shards only.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.sharding import (Rules, abstract_tensor, fake_mode, from_local,
                                         local_shape_offset)
from repro_torch.models.xlstm import xlstm_dims

EXPERT_PAD = 16   # the reference's expert-parallel degree the expert dim divides by
VOCAB_PAD = 256


@dataclasses.dataclass(frozen=True)
class PSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis names (models/sharding.py)
    init: str = "normal"  # normal | zeros | ones | lru_a
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"PSpec shape {self.shape} and axes {self.axes} differ in rank")


def padded_vocab(cfg: ModelConfig) -> int:
    return cfg.padded_vocab(VOCAB_PAD) if cfg.vocab_size >= VOCAB_PAD else cfg.vocab_size


def padded_experts(cfg: ModelConfig) -> int:
    """Experts in the parameter tree: padded to ``EXPERT_PAD`` from 16
    experts up (granite's 40 -> 48), as the reference lays them out."""
    if not cfg.is_moe:
        return 0
    if cfg.num_experts >= EXPERT_PAD:
        return cfg.padded_experts(EXPERT_PAD)
    return cfg.num_experts


# --- per-block specs ----------------------------------------------------------

def _norm_spec(cfg: ModelConfig) -> Dict[str, PSpec]:
    d = cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"scale": PSpec((d,), (None,), "zeros")}
    return {"scale": PSpec((d,), (None,), "ones"), "bias": PSpec((d,), (None,), "zeros")}


def _inner_norm_spec(width: int) -> Dict[str, PSpec]:
    return {"scale": PSpec((width,), (None,), "zeros")}


def _mlp_spec(cfg: ModelConfig) -> Dict[str, PSpec]:
    d, ff = cfg.d_model, cfg.d_ff
    out = {"w_up": PSpec((d, ff), ("embed_w", "ffn_w")),
           "w_down": PSpec((ff, d), ("ffn_w", "embed_w"))}
    if cfg.activation in ("swiglu", "geglu"):
        out["w_gate"] = PSpec((d, ff), ("embed_w", "ffn_w"))
    return out


def _moe_spec(cfg: ModelConfig) -> Dict[str, PSpec]:
    d, ff = cfg.d_model, cfg.d_ff
    e = padded_experts(cfg)
    out = {"router": PSpec((d, e), ("embed_w", None)),
           "we_up": PSpec((e, d, ff), ("experts_w", "embed_w", None)),
           "we_down": PSpec((e, ff, d), ("experts_w", None, "embed_w"))}
    if cfg.activation in ("swiglu", "geglu"):
        out["we_gate"] = PSpec((e, d, ff), ("experts_w", "embed_w", None))
    return out


def _attn_spec(cfg: ModelConfig, cross: bool = False) -> Dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p: Dict = {
        "ln1": _norm_spec(cfg),
        "wq": PSpec((d, h, hd), ("embed_w", "heads_w", None)),
        "wk": PSpec((d, kv, hd), ("embed_w", "kv_heads_w", None)),
        "wv": PSpec((d, kv, hd), ("embed_w", "kv_heads_w", None)),
        "wo": PSpec((h, hd, d), ("heads_w", None, "embed_w")),
        "ln2": _norm_spec(cfg),
    }
    if cfg.qkv_bias:
        p["bq"] = PSpec((h, hd), ("heads_w", None), "zeros")
        p["bk"] = PSpec((kv, hd), ("kv_heads_w", None), "zeros")
        p["bv"] = PSpec((kv, hd), ("kv_heads_w", None), "zeros")
    if cross:
        p["xgate"] = PSpec((1,), (None,), "zeros")
        p["kv_norm"] = _norm_spec(cfg)
    if cfg.is_moe:
        p["moe"] = _moe_spec(cfg)
    elif cfg.d_ff > 0:
        p["mlp"] = _mlp_spec(cfg)
    return p


def _rec_spec(cfg: ModelConfig) -> Dict:
    d, w, cw = cfg.d_model, cfg.lru_width, cfg.conv_width
    p: Dict = {
        "ln1": _norm_spec(cfg),
        "w_in": PSpec((d, w), ("embed_w", "lru_w")),
        "w_gate_in": PSpec((d, w), ("embed_w", "lru_w")),
        "conv_w": PSpec((cw, w), (None, "lru_w")),
        "conv_b": PSpec((w,), ("lru_w",), "zeros"),
        # diagonal RG-LRU gates (block-diagonal in Griffin)
        "a_param": PSpec((w,), ("lru_w",), "lru_a"),
        "gate_a_w": PSpec((w,), ("lru_w",), "zeros"),
        "gate_a_b": PSpec((w,), ("lru_w",), "zeros"),
        "gate_x_w": PSpec((w,), ("lru_w",), "zeros"),
        "gate_x_b": PSpec((w,), ("lru_w",), "zeros"),
        "w_out": PSpec((w, d), ("lru_w", "embed_w")),
        "ln2": _norm_spec(cfg),
    }
    if cfg.d_ff > 0:
        p["mlp"] = _mlp_spec(cfg)
    return p


def _mlstm_spec(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    di, nh, dh = xlstm_dims(cfg)
    # xlstm-350m has 4 heads, far fewer than the 16-way model axis, so TP
    # shards the per-head feature dims: q and k, on the contracted side of
    # the recurrence, stay replicated; v and the state's value dim are
    # model-sharded
    return {
        "ln": _norm_spec(cfg),
        "w_up": PSpec((d, 2 * di), ("embed_w", "inner_w")),
        "wq": PSpec((nh, dh, dh), (None, None, None)),
        "wk": PSpec((nh, dh, dh), (None, None, None)),
        "wv": PSpec((nh, dh, dh), (None, None, "inner_w")),
        "w_if": PSpec((nh, dh, 2), (None, None, None), "zeros"),
        "b_if": PSpec((nh, 2), (None, None), "zeros"),
        "mh_norm": _inner_norm_spec(di),
        "w_down": PSpec((di, d), ("inner_w", "embed_w")),
    }


def _slstm_spec(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    di, nh, dh = xlstm_dims(cfg)
    # the recurrence mixes the whole per-head state every step, so its
    # internals stay replicated; TP re-enters at the down projection
    return {
        "ln": _norm_spec(cfg),
        "w_in": PSpec((d, 4, nh, dh), ("embed_w", None, None, None)),
        "b_in": PSpec((4, nh, dh), (None, None, None), "zeros"),
        # block-diagonal (per-head) recurrent matrix R: raw_t += h_{t-1} R
        "w_rec": PSpec((nh, dh, 4, dh), (None, None, None, None), "normal", 0.01),
        "mh_norm": _inner_norm_spec(di),
        "w_down": PSpec((di, d), ("inner_w", "embed_w")),
    }


_BLOCK_SPECS = {"attn": _attn_spec, "xattn": lambda cfg: _attn_spec(cfg, cross=True),
                "rec": _rec_spec, "mlstm": _mlstm_spec, "slstm": _slstm_spec}


def model_spec(cfg: ModelConfig) -> Dict:
    """PSpec tree.  ``"groups"`` entries are stacked with a leading
    ``cfg.num_groups`` dim when materialized; ``"tail"`` entries are
    per-layer.  An ``embed``-input model has no token table; an untied
    head is ``(codebooks, d, V)`` (one codebook for a text model)."""
    d = cfg.d_model
    v = padded_vocab(cfg)
    spec: Dict = {"embed": {}, "groups": {}, "tail": {}, "final_norm": _norm_spec(cfg)}
    if cfg.input_mode == "token":
        spec["embed"]["tok"] = PSpec((v, d), ("vocab_w", "embed_w"), "normal", 0.02)
    if not cfg.tie_embeddings:
        spec["head"] = {"w": PSpec((max(1, cfg.num_codebooks), d, v),
                                   (None, "embed_w", "vocab_w"))}
    for i, kind in enumerate(cfg.block_pattern):
        spec["groups"][f"b{i}_{kind}"] = _BLOCK_SPECS[kind](cfg)
    for i, kind in enumerate(cfg.tail_pattern):
        spec["tail"][f"t{i}_{kind}"] = _BLOCK_SPECS[kind](cfg)
    return spec


def _leaf_shape(cfg: ModelConfig, path, ps: PSpec) -> Tuple[int, ...]:
    return ((cfg.num_groups,) if path[0] == "groups" else ()) + ps.shape


def _leaf_axes(path, ps: PSpec) -> Tuple[Optional[str], ...]:
    """A grouped leaf's stacking dim is replicated (a leading None)."""
    return ((None,) if path[0] == "groups" else ()) + ps.axes


def abstract_params(cfg: ModelConfig, rules: Optional[Rules] = None) -> Dict:
    """The parameter tree as fake tensors in ``cfg.param_dtype``: nothing is
    allocated.  Under rules with a mesh each leaf is a ``DTensor`` over a
    fake local shard, placed by its logical axes (:func:`partition_specs`).
    The fake tensors belong to the active ``FakeTensorMode``, or to a new
    one."""
    dtype = getattr(torch, cfg.param_dtype)
    out: Dict = {}
    with fake_mode():
        for path, ps in _leaves(model_spec(cfg)):
            _set(out, path, abstract_tensor(_leaf_shape(cfg, path, ps), dtype, rules,
                                            _leaf_axes(path, ps)))
    return out


def partition_specs(cfg: ModelConfig, rules: Rules) -> Dict:
    """The parameter tree's specs under ``rules``: per leaf a tuple of mesh
    axes per dim, the reference's ``PartitionSpec`` entries."""
    out: Dict = {}
    for path, ps in _leaves(model_spec(cfg)):
        _set(out, path, rules.spec(_leaf_axes(path, ps), shape=_leaf_shape(cfg, path, ps)))
    return out


def param_bytes(cfg: ModelConfig) -> int:
    """Bytes of the parameter tree in ``cfg.param_dtype``, padded vocab and
    padded experts included, from the spec alone (nothing is drawn)."""
    g = cfg.num_groups
    n = sum(math.prod(ps.shape) * (g if path[0] == "groups" else 1)
            for path, ps in _leaves(model_spec(cfg)))
    return n * getattr(torch, cfg.param_dtype).itemsize


def local_bytes(params: Dict) -> int:
    """Bytes of the tensors this process holds of a parameter tree: each
    ``DTensor``'s local shard, each plain tensor whole."""
    total = 0
    for _, leaf in _leaves(params):
        t = leaf.to_local() if hasattr(leaf, "to_local") else leaf
        total += t.numel() * t.element_size()
    return total


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


def init_params(cfg: ModelConfig, *, generator: torch.Generator, device=None,
                rules: Optional[Rules] = None) -> Dict:
    """Random weights in ``cfg.param_dtype`` (fp8 too: drawn in fp32, then
    cast), drawn on ``device`` from
    ``generator`` with the reference's initializers: norms at zero (RMSNorm
    scales by 1 + scale) or one, the fan-in-scaled normal, and ``lru_a``.
    Grouped leaves are drawn one group at a time, so the fp32 draw never
    holds more than one layer's matrix.  The numbers differ from the
    reference's ``jax.random`` streams; the parity tests carry the
    reference's own weights over with :func:`params_from_numpy`.

    Under ``rules`` with a mesh each leaf is a ``DTensor`` placed by
    :func:`partition_specs` that holds only this rank's shard: every rank
    draws every value in the same order from the same generator, keeps its
    shard of each draw and drops the rest, so ``full_tensor()`` of a leaf is
    bitwise the unsharded leaf and a rank's peak is its shards plus one
    draw (a group slice, or an ungrouped leaf whole)."""
    dtype = getattr(torch, cfg.param_dtype)
    mesh = None if rules is None else rules.mesh
    out: Dict = {}
    for path, ps in _leaves(model_spec(cfg)):
        grouped = path[0] == "groups"
        shape = _leaf_shape(cfg, path, ps)
        placements = None
        local, offset = shape, (0,) * len(shape)
        if mesh is not None:
            placements = rules.placements(rules.spec(_leaf_axes(path, ps), shape=shape))
            local, offset = local_shape_offset(shape, mesh, placements)
        lead = 1 if grouped else 0  # the group dim is never split
        if ps.init in ("zeros", "ones"):
            leaf = torch.full(local, 1.0 if ps.init == "ones" else 0.0,
                              dtype=dtype, device=device)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            ps = dataclasses.replace(ps, scale=min(ps.scale, 1.0 / math.sqrt(max(fan_in, 1))))
            if grouped:
                leaf = torch.empty(local, dtype=dtype, device=device)
                for g in range(cfg.num_groups):
                    leaf[g] = _narrow(_draw(ps, ps.shape, generator, device, dtype),
                                      local[lead:], offset[lead:])
            else:
                leaf = _narrow(_draw(ps, shape, generator, device, dtype), local, offset)
        _set(out, path, leaf if mesh is None else from_local(leaf, mesh, placements, shape))
    return out


def place_params(params: Dict, cfg: ModelConfig, rules: Rules) -> Dict:
    """A whole parameter tree (``init_params`` without rules,
    ``params_from_numpy``) as ``DTensor``s placed by :func:`partition_specs`
    on the rules' mesh: each rank keeps its own shard of every leaf, cut
    locally (no collective; a whole leaf is shared, not copied)."""
    specs = dict(_leaves(partition_specs(cfg, rules)))
    out: Dict = {}
    for path, leaf in _leaves(params):
        placements = rules.placements(specs[path])
        local, offset = local_shape_offset(leaf.shape, rules.mesh, placements)
        _set(out, path, from_local(_narrow(leaf, local, offset), rules.mesh, placements,
                                   leaf.shape))
    return out


def _narrow(t: torch.Tensor, shape, offset) -> torch.Tensor:
    """The block of ``t`` of ``shape`` at ``offset``: a copy of its own
    where it is a part (so the whole can be freed), ``t`` itself where it is
    all of ``t``."""
    part = t
    for d, (n, o) in enumerate(zip(shape, offset)):
        if n != t.shape[d]:
            part = part.narrow(d, o, n)
    return part.clone() if part is not t else t


def params_from_numpy(tree: Dict, *, device=None) -> Dict:
    """The reference's ``init_params`` tree (leaves as numpy arrays or
    anything ``np.asarray`` takes) -> the same tree of tensors on
    ``device``, each in its own dtype (numpy-side bfloat16 arrives as
    ``torch.bfloat16``; float8_e4m3fn and float8_e5m2 bit for bit, through
    their bytes).  :func:`place_params` lays it over a mesh."""
    out: Dict = {}
    for path, leaf in _leaves(tree):
        arr = np.asarray(leaf)
        name = arr.dtype.name
        if name in _FP8:
            t = torch.from_numpy(np.array(arr).view(np.uint8)).view(_FP8[name])
        elif name == "bfloat16":
            t = torch.from_numpy(np.array(arr, dtype=np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr, dtype=arr.dtype))
        _set(out, path, t.to(device=device))
    return out


#: numpy (ml_dtypes) fp8 names -> torch dtypes of the same bits
_FP8 = {"float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2}


def group_params(params: Dict, g: int) -> Dict:
    """Group ``g``'s slice of the stacked ``"groups"`` subtree (views)."""
    return {key: _index(sub, g) for key, sub in params["groups"].items()}


def group_slices(params: Dict, num_groups: int) -> List[Dict]:
    """Every group's slice of the stacked ``"groups"`` subtree, from one
    ``torch.unbind`` per leaf (views).  In training a leaf's gradient is
    then one stack of its groups' gradients; indexing each group apart
    would zero-fill and add the whole stacked gradient once per group."""
    out: List[Dict] = [{} for _ in range(num_groups)]
    for path, leaf in _leaves(params["groups"]):
        for g, view in enumerate(torch.unbind(leaf, 0)):
            _set(out[g], path, view)
    return out


def _index(tree: Dict, g: int) -> Dict:
    return {k: (_index(v, g) if isinstance(v, dict) else v[g]) for k, v in tree.items()}
