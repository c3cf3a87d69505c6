"""Analytic device/link cost model (numpy), the planner's input.

Devices and links describe the edge cluster the planner partitions for,
not the GPU the port runs on; memory footprints are fp16 parameter bytes
(paper §II-B).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Union

from repro_torch.configs.base import ModelConfig

BYTES_FP16 = 2
# The paper's prototype (PyTorch + gloo on CPU) synchronizes fp32 activation
# tensors even when weights are fp16 — gloo has no fp16 ring collectives.
BYTES_ACT = 4


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    name: str
    flops: float            # effective FLOP/s
    mem_bw: float           # effective bytes/s
    memory_budget: float    # bytes usable for weights


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    bandwidth: float        # bytes/s
    latency: float = 1e-3   # per-hop software+switch latency (Ethernet)


def mbps(x: float) -> LinkSpec:
    return LinkSpec(bandwidth=x * 1e6 / 8)


# one LinkSpec for every hop, or one per device — entry i is the *outgoing*
# link of ring device i (i -> i+1 mod D)
Links = Union[LinkSpec, Sequence[LinkSpec]]


def as_ring_links(link: Links, d: int) -> List[LinkSpec]:
    """Normalize to one outgoing LinkSpec per ring device."""
    if isinstance(link, LinkSpec):
        return [link] * d
    links = list(link)
    if len(links) != d:
        raise ValueError(f"{len(links)} links for a ring of {d} devices")
    return links


def t_ring_exchange(tile_bytes: Sequence[float], link: Links) -> float:
    """Total time of one D-1-step ring rotation of (possibly uneven) tiles.

    At step r device i forwards the tile originally owned by device
    (i - r) mod D over its outgoing link; the step completes when the
    slowest (tile bytes / link) pair finishes.
    """
    d = len(tile_bytes)
    if d <= 1:
        return 0.0
    links = as_ring_links(link, d)
    total = 0.0
    for r in range(d - 1):
        total += max(
            tile_bytes[(i - r) % d] / links[i].bandwidth + links[i].latency
            for i in range(d)
        )
    return total


def layer_profile(cfg: ModelConfig, seq: int) -> Dict[str, float]:
    """FLOPs / bytes of one Transformer layer (Fig. 2) at a sequence length."""
    d, ff, h = cfg.d_model, cfg.d_ff, cfg.num_heads
    hd = cfg.head_dim
    kv = cfg.num_kv_heads
    qkvo_flops = 2 * seq * d * (h * hd + 2 * kv * hd) + 2 * seq * (h * hd) * d
    attn_flops = 2 * 2 * seq * seq * h * hd
    gate = 3 if cfg.activation in ("swiglu", "geglu") else 2
    mlp_flops = gate * 2 * seq * d * ff
    # connective: dropout + residual + layernorm, ~4 passes over activations
    con_bytes = 2 * 4 * seq * d * BYTES_ACT * 2
    m_att = (d * (h * hd + 2 * kv * hd) + (h * hd) * d) * BYTES_FP16
    m_mlp = gate * d * ff * BYTES_FP16
    return {
        "mha_flops": qkvo_flops + attn_flops,
        "mlp_flops": mlp_flops,
        "con_bytes": con_bytes,
        "m_att": m_att,
        "m_mlp": m_mlp,
        "act_bytes": seq * d * BYTES_ACT,
    }
