"""Shared layer primitives: norms, rotary and sinusoidal positions,
dropout, activations and the Galaxy "connective block" (dropout +
residual add + norm).

The connective block is the SP region of the paper (§III-B-3): its
``seq`` constraints (``models/sharding.py``) make the exit of the TP block
before it a ReduceScatter under a mesh; on one device they return their
input.

Dropout is split in two: :func:`dropout_mask` draws a keep mask from an
explicit ``torch.Generator``, :func:`apply_dropout` applies a given mask.
A train step's masks come from a :class:`DropoutStream`, which seeds one
generator per (step seed, layer, site), as ``jax.random.fold_in`` gives the
reference one key per layer: a group recomputed under remat draws the same
masks again, whatever the global RNG did in between.  ``models/
transformer.py`` opens a :func:`dropout_scope` around each block in train
mode, and every :func:`connective_residual` inside it drops the sub-layer's
output with the next site's mask; outside a scope the residual is a plain
add (serving, eval, ``dropout_rate == 0``).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

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


# --- dropout -------------------------------------------------------------------

def dropout_mask(shape, rate: float, generator: torch.Generator, device=None) -> torch.Tensor:
    """Keep mask (bool, ``shape``): each element kept with probability
    ``1 - rate``, drawn from ``generator``."""
    u = torch.rand(shape, generator=generator, device=device or generator.device)
    return u < 1.0 - rate


def apply_dropout(x, keep, rate: float):
    """``x / (1 - rate)`` where ``keep``, 0 elsewhere (the reference's
    ``jnp.where(mask, x / keep, 0)``, in ``x``'s dtype)."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x, rate: float, generator: Optional[torch.Generator], deterministic: bool):
    """The reference's ``dropout(x, rate, rng, deterministic)`` with a
    torch generator in place of the key: ``x`` itself when deterministic,
    at rate 0 or without a generator."""
    if deterministic or rate == 0.0 or generator is None:
        return x
    return apply_dropout(x, dropout_mask(x.shape, rate, generator, x.device), rate)


class DropoutStream:
    """The dropout masks of one train step: ``mask(layer, site, shape,
    rate, device)`` draws from a generator seeded with the hash of (seed,
    layer, site) (an int tuple's hash does not depend on the process), so
    the same (layer, site) gets the same mask in the forward and in a
    remat recompute.  jax.random bits have no torch twin:
    a test that holds the port to the reference subclasses this and hands
    back the reference's own masks."""

    def __init__(self, seed: int):
        self.seed = int(seed)

    def mask(self, layer: int, site: int, shape, rate: float, device) -> torch.Tensor:
        seed = hash((self.seed, layer, site)) % 2 ** 63
        gen = torch.Generator(device=device).manual_seed(seed)
        return dropout_mask(shape, rate, gen, device)


_SCOPE = threading.local()


@contextlib.contextmanager
def dropout_scope(stream: Optional[DropoutStream], layer: int, rate: float):
    """Inside, the i-th :func:`connective_residual` drops its sub-layer's
    output with ``stream.mask(layer, i, ...)``; a null scope without a
    stream or at rate 0."""
    prev = getattr(_SCOPE, "state", None)
    _SCOPE.state = [stream, layer, rate, 0] if stream is not None and rate > 0 else None
    try:
        yield
    finally:
        _SCOPE.state = prev


@contextlib.contextmanager
def batched_products():
    """Marks the products inside as batched (the reference contracts them
    with ``dot_general`` batch dimensions) whatever their batch extent, so
    remat "dots" (``models/transformer.py:dots_policy``) recomputes them:
    the MoE's dispatch and combine over one token group lower to
    ``bmm`` with batch extent 1, which alone reads as a 2-D product."""
    prev = getattr(_SCOPE, "batched", False)
    _SCOPE.batched = True
    try:
        yield
    finally:
        _SCOPE.batched = prev


def products_batched() -> bool:
    """Whether the running product sits inside :func:`batched_products`."""
    return getattr(_SCOPE, "batched", False)


# --- the Galaxy connective block ------------------------------------------------

def connective_residual(residual, sublayer_out):
    """Residual add of a sub-layer's output, dropped out first inside a
    :func:`dropout_scope`."""
    sublayer_out = constrain(sublayer_out, BSE)
    residual = constrain(residual, BSE)
    state = getattr(_SCOPE, "state", None)
    if state is not None:
        stream, layer, rate, site = state
        state[3] += 1
        keep = stream.mask(layer, site, sublayer_out.shape, rate, sublayer_out.device)
        sublayer_out = apply_dropout(sublayer_out, keep, rate)
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
