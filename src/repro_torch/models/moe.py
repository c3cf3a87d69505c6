"""Mixture-of-Experts block (granite-moe, olmoe).

GShard-style capacity-based dispatch and combine, as the reference computes
it: tokens are cut into groups of ``_group_size`` rows, each expert takes
at most ``moe_capacity`` tokens of a group, and a token's slots are taken
slot by slot in token order (every token's first choice before any
token's second), so a token past an expert's capacity is dropped there.
The reference leaves the whole block to XLA (einsums, no Pallas kernel),
so here it stays torch ops: cuBLAS batched GEMMs over the experts.

Experts are padded in the parameter tree (``models/params.py``); pad
experts get -1e30 router logits and are never selected.

Under a mesh (``models/sharding.py``) the token groups are sharded over
the data axes (``expert_group``) and the experts over the model axis
(expert parallelism): dispatch is a local slice, and the combine's
contraction over the sharded experts leaves partial sums whose exit into
the seq-sharded connective block is the ReduceScatter every HMP TP block
ends with.

Three details keep the routing identical to the reference's:

* top-k takes the lower expert index first on equal logits, as
  ``jax.lax.top_k`` does (a stable descending sort; ``torch.topk`` names
  no order for ties, and bf16 router logits tie);
* a dropped slot's one-hot position row is all zero (``jax.nn.one_hot``
  of the out-of-range index ``cap``), built here as a comparison with
  ``arange(cap)`` (``torch.nn.functional.one_hot`` raises on it);
* every row the caller passes joins the token groups: pad rows of a
  prefill and the idle slots of a decode batch compete for capacity, as
  they do in the reference.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (batched_products, connective_norm, connective_residual,
                                       gelu)
from repro_torch.models.sharding import constrain

CAPACITY_FACTOR = 2.0
GROUP_SIZE = 128
AUX_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")


def _group_size(total_tokens: int) -> int:
    """The largest divisor of ``total_tokens`` that is at most
    ``GROUP_SIZE`` (a prime length gives groups of 1)."""
    t = min(GROUP_SIZE, total_tokens)
    while total_tokens % t:
        t -= 1
    return t


def moe_capacity(cfg: ModelConfig, group_tokens: int, capacity_factor: float = 0.0) -> int:
    cf = capacity_factor or cfg.moe_capacity_factor
    c = int(cf * cfg.experts_per_token * group_tokens / cfg.num_experts)
    return max(c, 1)


def moe_route(p: Dict, xg, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router of token groups xg (g, t, d): fp32 logits (g, t, e_pad) with
    the pad experts at -1e30, and the top-k values and expert indices
    (g, t, k), the lower index first on ties."""
    e_pad = p["router"].shape[-1]
    logits = (xg @ p["router"]).float()
    valid = torch.arange(e_pad, device=xg.device) < cfg.num_experts
    logits = torch.where(valid, logits, torch.full((), -1e30, device=xg.device))
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    return logits, vals[..., :k], idx[..., :k]


def moe_apply(p: Dict, x, cfg: ModelConfig, *, capacity_factor: float = 0.0
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (out (B, S, d), aux): the load-balance loss (Switch
    eq. 4), the router z-loss and the fraction of token slots dropped."""
    b, s, d = x.shape
    e_pad = p["we_up"].shape[0]
    k = cfg.experts_per_token
    total = b * s
    t = _group_size(total)
    g = total // t
    xg = constrain(x.reshape(g, t, d), ("expert_group", None, "embed"))

    logits, top_vals, top_idx = moe_route(p, xg, cfg)
    probs = torch.softmax(logits, dim=-1)  # (g, t, e) — for the aux loss
    top_w = torch.softmax(top_vals, dim=-1)  # normalized combine weights

    # --- capacity assignment (GShard) ------------------------------------
    cap = moe_capacity(cfg, t, capacity_factor)
    experts = torch.arange(e_pad, device=x.device)
    slots = torch.arange(cap, device=x.device)
    combine = torch.zeros((g, t, e_pad, cap), dtype=torch.float32, device=x.device)
    counts = torch.zeros((g, e_pad), dtype=torch.long, device=x.device)
    for j in range(k):
        oh = (top_idx[:, :, j, None] == experts).long()  # (g, t, e)
        pos = torch.cumsum(oh, dim=1) - oh + counts[:, None, :]
        keep = (pos < cap) & (oh > 0)
        # a dropped slot's index is cap: its position row is all zero
        pos_oh = (torch.where(keep, pos, cap)[..., None] == slots).float()
        combine = combine + top_w[:, :, j, None, None] * oh[..., None] * pos_oh
        counts = counts + oh.sum(dim=1)
    dispatch = constrain((combine > 0).to(x.dtype), ("expert_group", None, "experts", None))
    combine = constrain(combine.to(x.dtype), ("expert_group", None, "experts", None))

    # --- expert FFN: one batched GEMM per matrix over the experts ----------
    with batched_products():  # batched over the groups, as in the reference
        xe = torch.einsum("gtec,gtd->gecd", dispatch, xg)
    xe = constrain(xe, ("expert_group", "experts", None, None))
    if cfg.activation in ("swiglu", "geglu"):
        act = F.silu if cfg.activation == "swiglu" else gelu
        h = act(torch.einsum("gecd,edf->gecf", xe, p["we_gate"])) * torch.einsum(
            "gecd,edf->gecf", xe, p["we_up"])
    else:
        h = gelu(torch.einsum("gecd,edf->gecf", xe, p["we_up"]))
    h = constrain(h, ("expert_group", "experts", None, None))
    ye = torch.einsum("gecf,efd->gecd", h, p["we_down"])

    # --- combine ---------------------------------------------------------
    # experts and slots merged experts-major, so under a mesh the experts'
    # shard is the merged dim's (an einsum may merge them slots-major)
    e_c = combine.shape[2] * combine.shape[3]
    with batched_products():
        out = torch.bmm(combine.reshape(g, t, e_c), ye.reshape(g, e_c, d)).reshape(b, s, d)

    # --- aux losses --------------------------------------------------------
    top1 = (top_idx[:, :, 0, None] == experts).float()
    f_e = top1.mean(dim=(0, 1))
    p_e = probs.mean(dim=(0, 1))
    lb_loss = cfg.num_experts * torch.sum(f_e * p_e)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    dropped = 1.0 - torch.sum(dispatch.float()) / (g * t * k)
    return out, {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss, "moe_drop_frac": dropped}


def moe_block(p: Dict, x, cfg: ModelConfig):
    """The FFN sub-layer of an MoE block: norm -> experts -> residual.
    Returns (x, aux)."""
    xn = connective_norm(x, p["ln2"], cfg.norm)
    xg = constrain(xn, ("batch", None, "embed"))  # AllGather: enter the TP block
    out, aux = moe_apply(p["moe"], xg, cfg)
    return connective_residual(x, out), aux  # ReduceScatter
