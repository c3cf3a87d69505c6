"""Analytic device/link cost model (numpy), the planner's and the
simulator's input.

Devices and links describe the edge cluster the planner partitions for,
not the GPU the port runs on.  Calibrated against the paper's own
measurements (§II-B Table I): Bert-L (24 layers, d 1024) at seq 30 on a
Nano-M (0.825 GHz) takes 2.43 s, ~8.6 GFLOP/s per GHz of the quad A53,
and the same constant predicts DistilBert at 0.36 s (paper: 0.37 s).
Memory footprints are fp16 parameter bytes (paper §II-B).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Union

from repro_torch.configs.base import ModelConfig

# --- edge devices ------------------------------------------------------------

GFLOPS_PER_GHZ = 8.6e9           # calibrated vs paper Table I (CPU mode)
NANO_MEM_BW = 4.0e9              # effective LPDDR4 bandwidth under CPU load
NANO_GPU_GFLOPS = 120e9          # 128-core Maxwell @460MHz, ~fp16 effective
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


def jetson_nano(kind: str, memory_budget_gb: float) -> DeviceSpec:
    freq = {"nano-l": 1.47e9, "nano-m": 0.825e9, "nano-s": 0.403e9}[kind]
    return DeviceSpec(
        name=kind,
        flops=GFLOPS_PER_GHZ * freq / 1e9,
        mem_bw=NANO_MEM_BW,
        memory_budget=memory_budget_gb * 1e9,
    )


def jetson_nano_gpu(memory_budget_gb: float = 1.5) -> DeviceSpec:
    return DeviceSpec("nano-gpu", NANO_GPU_GFLOPS, 12e9, memory_budget_gb * 1e9)


def edge_env(env_id: str) -> List[DeviceSpec]:
    """The paper's edge environments A-F (Table III)."""
    n = jetson_nano
    return {
        "A": [n("nano-m", 1.5)] * 2,
        "B": [n("nano-m", 1.5)] * 3,
        "C": [n("nano-m", 1.5)] * 4,
        "D": [n("nano-l", 1.5), n("nano-m", 1.2)],
        "E": [n("nano-l", 1.5), n("nano-s", 0.7)],
        "F": [n("nano-l", 1.5), n("nano-m", 1.2), n("nano-s", 0.7)],
    }[env_id]


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


def bottleneck_link(link: Links, d: int) -> LinkSpec:
    """Slowest hop: what gates a synchronized full-tensor ring collective."""
    return min(as_ring_links(link, d), key=lambda l: l.bandwidth)


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


# --- NVIDIA H100 (roofline targets) --------------------------------------------
#
# Datasheet figures of the card the port runs on, NVIDIA H100 80GB HBM3
# (SXM) at its 700 W power limit: dense tensor-core rates without sparsity,
# fp32 outside the tensor cores (the port keeps TF32 off), HBM3 bandwidth,
# NVLink 4 bandwidth in one direction.  They are not measurements; a card
# set below 700 W reaches less.  The roofline (``roofline/analysis.py``)
# prices a step on them.

H100 = {
    "name": "NVIDIA H100 80GB HBM3",
    "power_limit_w": 700.0,
    "peak_flops": {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12},
    "hbm_bw": 3.35e12,        # bytes/s
    "nvlink_bw": 450e9,       # bytes/s, one direction
    "hbm_bytes": 80e9,
}


def h100_peak_flops(dtype: str) -> float:
    """Peak FLOP/s of the H100 for a compute dtype name."""
    return H100["peak_flops"][dtype]


# --- collective cost (ring algorithms, paper §III-B-5) ------------------------

def t_allgather(n_bytes: float, d: int, link: LinkSpec) -> float:
    """Ring AllGather of a global tensor of n_bytes (each device holds n/D)."""
    if d <= 1:
        return 0.0
    return (d - 1) / d * n_bytes / link.bandwidth + (d - 1) * link.latency


def t_reducescatter(n_bytes: float, d: int, link: LinkSpec) -> float:
    if d <= 1:
        return 0.0
    return (d - 1) / d * n_bytes / link.bandwidth + (d - 1) * link.latency


def t_allreduce(n_bytes: float, d: int, link: LinkSpec) -> float:
    """Ring AllReduce = ReduceScatter + AllGather (paper §III-B-5)."""
    return t_allgather(n_bytes, d, link) + t_reducescatter(n_bytes, d, link)


# --- per-layer workload profile of a paper-style Transformer layer ------------

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


def gemm_unit_flops(d_model: int, head_dim: int) -> Dict[str, float]:
    """Dense GEMM FLOPs one partition unit costs per sequence row.

    One MHA head: its QKV projection columns (3 x 2·d·hd) plus its WO rows
    (2·hd·d).  One MLP column: its W1 column (2·d) plus its W2 row (2·d).
    ``ExecPlan.device_gemm_flops`` prices units with this.
    """
    return {"head": 8 * d_model * head_dim, "column": 4 * d_model}


def model_memory_bytes(cfg: ModelConfig) -> float:
    prof = layer_profile(cfg, 1)
    embed = cfg.vocab_size * cfg.d_model * BYTES_FP16
    return cfg.num_layers * (prof["m_att"] + prof["m_mlp"]) + embed


# --- speculative decoding (serving/spec.py) -----------------------------------

def spec_expected_tokens(acceptance: float, k: int) -> float:
    """Expected tokens emitted per speculative round with k drafts.

    A round emits the longest accepted draft prefix plus one token from the
    verifier itself (the correction on a mismatch, the bonus row when all k
    match).  With per-position agreement i.i.d. at probability
    ``acceptance``, the mean is ``1 + a + ... + a^k = (1 - a^(k+1)) / (1 -
    a)``: between 1 (a = 0) and k + 1 (a = 1).
    """
    if not 0.0 <= acceptance <= 1.0:
        raise ValueError(f"acceptance {acceptance} must lie in [0, 1]")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if acceptance == 1.0:
        return float(k + 1)
    return (1.0 - acceptance ** (k + 1)) / (1.0 - acceptance)


# --- calibration hooks --------------------------------------------------------

# constants a measured-vs-simulated loop may override; TILE_OVERHEAD belongs
# to the simulator (which imports this module), so it is resolved lazily
_CALIBRATABLE = ("GFLOPS_PER_GHZ", "NANO_MEM_BW", "BYTES_ACT", "TILE_OVERHEAD")


def apply_calibration(overrides: Dict[str, float]) -> Dict[str, float]:
    """Override calibratable cost-model constants; returns the previous
    values so a calibration experiment can restore them (try/finally).
    Unknown names are refused before anything is touched."""
    unknown = set(overrides) - set(_CALIBRATABLE)
    if unknown:
        raise ValueError(
            f"{sorted(unknown)} are not calibratable (one of {_CALIBRATABLE})"
        )
    previous: Dict[str, float] = {}
    for name, value in overrides.items():
        if name == "TILE_OVERHEAD":
            from repro_torch.core import simulator

            previous[name] = simulator.TILE_OVERHEAD
            simulator.TILE_OVERHEAD = float(value)
        else:
            previous[name] = globals()[name]
            globals()[name] = float(value)
    return previous
