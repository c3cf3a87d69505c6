"""MLP blocks.  The matmuls stay ``torch.matmul``: the reference computes
them as einsums outside any kernel."""
from __future__ import annotations

from typing import Dict

import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import connective_norm, connective_residual, gelu


def mlp_apply(p: Dict, x, cfg: ModelConfig):
    """x: (B, S, d) -> (B, S, d)."""
    if cfg.activation == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif cfg.activation == "geglu":
        h = gelu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = gelu(x @ p["w_up"])
    return h @ p["w_down"]


def mlp_block(p: Dict, x, cfg: ModelConfig):
    xn = connective_norm(x, p["ln2"], cfg.norm)
    return connective_residual(x, mlp_apply(p["mlp"], xn, cfg))
