"""RG-LRU recurrent block (Griffin / RecurrentGemma).

The recurrence h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t) is
diagonal, so every width column runs on its own.  Prefill runs it through
the RG-LRU scan kernel (``kernels/rglru_scan.py``); decode is a single
fused step in torch ops, as the reference leaves it to XLA.

Simplification vs Griffin (as in the reference): the r_t / i_t gates are
diagonal (per-channel) rather than block-diagonal dense.

Under a mesh (``models/sharding.py``) TP splits the recurrence width
(``lru``): the recurrence is diagonal, so the split needs no sync inside
the block.  There the kernel backend launches the scan kernel on each
rank's columns (:func:`_local_scan`); the eager backend, and so the dry
run's counts, runs a log-depth (Hillis-Steele) scan in torch ops, as the
reference runs ``jax.lax.associative_scan``: the kernel's plain version
steps through the sequence one row at a time, which a sharded tensor
cannot take.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import connective_norm, connective_residual, gelu
from repro_torch.models.sharding import constrain, from_local, mesh_active
from repro_torch.roofline import counter

RGLRU_C = 8.0

REC_CACHE_AXES = {"h": ("batch", "lru"), "conv": ("batch", None, "lru")}


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


def _scan_log_depth(a, b, h0):
    """h_t = a_t h_{t-1} + b_t along axis 1 of (B, S, w) in log2(S) steps:
    step k combines each row with the one 2^k before it,
    (a1, b1) then (a2, b2) -> (a1 a2, b1 a2 + b2).  Returns (h_seq,
    h_last) in fp32."""
    a, b = a.float(), b.float()
    b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]], dim=1)
    s, shift = a.shape[1], 1
    while shift < s:
        a_prev = torch.cat([torch.ones_like(a[:, :shift]), a[:, :-shift]], dim=1)
        b_prev = torch.cat([torch.zeros_like(b[:, :shift]), b[:, :-shift]], dim=1)
        b = b_prev * a + b
        a = a_prev * a
        shift *= 2
    return b, b[:, -1]


class _LogDepthScanFn(torch.autograd.Function):
    """:func:`_scan_log_depth` with the gradient ``kernels/rglru_scan.py``'s
    ``RGLRUScanFn`` computes (the same recurrence on reversed time), each
    direction counted as the scan it computes (``roofline/counter.py``)."""

    @staticmethod
    def forward(ctx, a, b, h0):
        with counter.function(*counter.scan_cost(a, b, h0)):
            h_seq, h_last = _scan_log_depth(a, b, h0)
        ctx.save_for_backward(a, h0, h_seq)
        return h_seq, h_last

    @staticmethod
    def backward(ctx, dh_seq, dh_last):
        a, h0, h_seq = ctx.saved_tensors
        flops, nbytes = counter.scan_cost(a, a, h0)
        with counter.function(2 * flops, 2 * nbytes):
            dh = torch.cat([dh_seq[:, :-1], dh_seq[:, -1:] + dh_last[:, None]], dim=1).float()
            # g_t = dh_t + a_{t+1} g_{t+1}: the forward scan on reversed time
            a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1).float()
            g, _ = _scan_log_depth(a_next.flip(1), dh.flip(1), torch.zeros_like(h0).float())
            g = g.flip(1)
            h_prev = torch.cat([h0.float()[:, None], h_seq[:, :-1]], dim=1)
            return ((g * h_prev).to(a.dtype), g.to(a.dtype),
                    (a[:, 0].float() * g[:, 0]).to(h0.dtype))


def _local_scan(a, b, h0):
    """``ops.rglru_scan`` on each rank's shards: the recurrence is diagonal
    and ``u`` is laid out ``("batch", None, "lru")``, so every rank holds
    whole sequences of its own columns and scans them alone."""
    a, b = (constrain(t, ("batch", None, "lru")) for t in (a, b))
    h0 = constrain(h0, ("batch", "lru"))
    h_seq, h_last = ops.rglru_scan(a.to_local(), b.to_local(), h0.to_local())
    return (from_local(h_seq, a.device_mesh, a.placements, a.shape),
            from_local(h_last, h0.device_mesh, h0.placements, h0.shape))


def rglru_block(p: Dict, x, cfg: ModelConfig, *, mode: str,
                cache: Optional[Dict], backend: str = "kernel") -> Tuple[torch.Tensor, Optional[Dict]]:
    """Griffin recurrent sub-layer: norm -> (gate branch * conv + RG-LRU
    branch) -> out-proj -> residual.  Returns (x, new_cache); the new
    cache is ``{"h": (B, w) fp32, "conv": (B, cw-1, w)}`` in prefill and
    decode, None in train.  Prefill and train run the scan through
    ``ops.rglru_scan`` (h0 = the cache's h, zeros without a cache)."""
    xn = connective_norm(x, p["ln1"], cfg.norm)
    xg = constrain(xn, ("batch", None, "embed"))  # AllGather: enter the TP block
    gate = constrain(gelu(xg @ p["w_gate_in"]), ("batch", None, "lru"))
    u = constrain(xg @ p["w_in"], ("batch", None, "lru"))

    conv_state = cache["conv"] if cache is not None else None
    u, new_conv = _causal_conv(u, p["conv_w"], p["conv_b"], conv_state)

    a, b = _gates(p, u)
    if mode == "decode":
        h_last = a[:, 0] * cache["h"] + b[:, 0]
        h_seq = h_last[:, None]
    else:
        h0 = (cache["h"] if cache is not None else
              torch.zeros((x.shape[0], a.shape[2]), dtype=torch.float32, device=x.device))
        if not mesh_active():
            h_seq, h_last = ops.rglru_scan(a, b, h0, backend=backend)
        elif backend == "eager":
            h_seq, h_last = _LogDepthScanFn.apply(a, b, constrain(h0, ("batch", "lru")))
        else:
            h_seq, h_last = _local_scan(a, b, h0)
    h_seq = constrain(h_seq.to(x.dtype), ("batch", None, "lru"))

    new_cache = None
    if mode in ("prefill", "decode"):
        new_cache = {"h": constrain(h_last, ("batch", "lru")),
                     "conv": constrain(new_conv, ("batch", None, "lru"))}

    out = (h_seq * gate) @ p["w_out"]  # row-parallel: partial sums
    return connective_residual(x, out), new_cache  # ReduceScatter
