"""Shared layer primitives: norms, rotary and sinusoidal positions,
activations and the Galaxy "connective block" (residual add + norm).

The connective block is the SP region of the paper (§III-B-3): its
``seq`` constraints (``models/sharding.py``) make the exit of the TP block
before it a ReduceScatter under a mesh; on one device they return their
input.  Serving runs and trains with dropout off (``models/transformer.py``
refuses a config with ``dropout_rate > 0``), so the residual is a plain add.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.sharding import constrain

#: the connective block's layout: sequence-sharded under HMP
BSE = ("batch", "seq", "embed")


# --- norms -----------------------------------------------------------------

def rmsnorm(x, scale, eps: float = 1e-6):
    """RMSNorm in fp32 that scales by ``1 + scale`` (Griffin's zero-init
    scale), cast back to ``x.dtype``."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def apply_norm(x, p, kind: str):
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


# --- positions ----------------------------------------------------------------

def rope(x, positions, theta: float = 10000.0):
    """Rotary embedding in the half-split layout (first half rotates with
    the second, not interleaved pairs).  x: (..., S, H, hd); positions:
    broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = torch.exp(-math.log(theta)
                     * torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freq  # (..., S, half)
    ang = ang[..., None, :]  # broadcast over heads
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(positions, d_model: int, dtype=torch.float32):
    """Sinusoidal position embeddings (B, S, d_model): sines of the first
    half of the frequencies, then cosines."""
    half = d_model // 2
    freq = torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# --- the Galaxy connective block ------------------------------------------------

def connective_residual(residual, sublayer_out):
    """Residual add of a sub-layer's output (dropout is off)."""
    sublayer_out = constrain(sublayer_out, BSE)
    residual = constrain(residual, BSE)
    return constrain(residual + sublayer_out, BSE)


def connective_norm(x, norm_params, norm_kind):
    x = constrain(x, BSE)
    return constrain(apply_norm(x, norm_params, norm_kind), BSE)


# --- activations ----------------------------------------------------------------

def gelu(x):
    # the reference's jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def activation_fn(name: str):
    return {"gelu": gelu, "silu": F.silu}.get(name, gelu)
