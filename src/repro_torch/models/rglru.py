"""RG-LRU recurrent block (Griffin / RecurrentGemma).

The recurrence h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t) is
diagonal, so every width column runs on its own.  Prefill runs it through
the RG-LRU scan kernel (``kernels/rglru_scan.py``); decode is a single
fused step in torch ops, as the reference leaves it to XLA.

Simplification vs Griffin (as in the reference): the r_t / i_t gates are
diagonal (per-channel) rather than block-diagonal dense.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import connective_norm, connective_residual, gelu

RGLRU_C = 8.0


def _causal_conv(u, conv_w, conv_b, conv_state):
    """Depthwise causal temporal conv of width cw.  u: (B, S, w); conv_w:
    (cw, w); conv_state: (B, cw-1, w) or None.  Returns the conv output and
    the new state: the last cw-1 rows of ``[state | u]``."""
    cw = conv_w.shape[0]
    if conv_state is None:
        pad = torch.zeros((u.shape[0], cw - 1, u.shape[2]), dtype=u.dtype, device=u.device)
    else:
        pad = conv_state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)  # (B, S+cw-1, w)
    out = torch.zeros_like(u)
    s = u.shape[1]
    for j in range(cw):
        out = out + full[:, j:j + s] * conv_w[j]
    # a copy, so the state does not keep the whole (B, S+cw-1, w) alive
    new_state = full[:, -(cw - 1):].clone() if cw > 1 else pad
    return out + conv_b, new_state


def _gates(p, u):
    """Diagonal RG-LRU gating.  Returns (a, b) of h_t = a*h_{t-1} + b, fp32."""
    uf = u.float()
    r = torch.sigmoid(p["gate_a_w"].float() * uf + p["gate_a_b"].float())
    i = torch.sigmoid(p["gate_x_w"].float() * uf + p["gate_x_b"].float())
    log_a = -RGLRU_C * F.softplus(p["a_param"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * uf)
    return a, b


def rglru_block(p: Dict, x, cfg: ModelConfig, *, mode: str,
                cache: Optional[Dict], backend: str = "kernel") -> Tuple[torch.Tensor, Optional[Dict]]:
    """Griffin recurrent sub-layer: norm -> (gate branch * conv + RG-LRU
    branch) -> out-proj -> residual.  Returns (x, new_cache); the new
    cache is ``{"h": (B, w) fp32, "conv": (B, cw-1, w)}`` in prefill and
    decode, None in train.  Prefill and train run the scan through
    ``ops.rglru_scan`` (h0 = the cache's h, zeros without a cache)."""
    xn = connective_norm(x, p["ln1"], cfg.norm)
    gate = gelu(xn @ p["w_gate_in"])
    u = xn @ p["w_in"]

    conv_state = cache["conv"] if cache is not None else None
    u, new_conv = _causal_conv(u, p["conv_w"], p["conv_b"], conv_state)

    a, b = _gates(p, u)
    if mode == "decode":
        h_last = a[:, 0] * cache["h"] + b[:, 0]
        h_seq = h_last[:, None]
    else:
        h0 = (cache["h"] if cache is not None else
              torch.zeros((x.shape[0], a.shape[2]), dtype=torch.float32, device=x.device))
        h_seq, h_last = ops.rglru_scan(a, b, h0, backend=backend)
    h_seq = h_seq.to(x.dtype)

    new_cache = None
    if mode in ("prefill", "decode"):
        new_cache = {"h": h_last, "conv": new_conv}

    out = (h_seq * gate) @ p["w_out"]
    return connective_residual(x, out), new_cache
