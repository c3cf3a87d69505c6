"""Roofline analysis of the dry run's counts, priced on the H100
(counterpart of ``src/repro/roofline/analysis.py``).

Three terms per (arch x shape x mesh), each in seconds a step per chip:

  compute    = FLOPs_per_chip / peak FLOP/s     (989 TFLOP/s bf16/fp16, 67 fp32)
  memory     = bytes_per_chip / HBM bandwidth   (3.35 TB/s)
  collective = collective_bytes_per_chip / NVLink bandwidth (450 GB/s a direction)

The counts come from ``launch/dryrun.py``: the step runs on fake tensors
under a ``StepCounter`` (``roofline/counter.py``) that sees every op each
chip runs, so the FLOPs, the bytes and the collectives are per chip as
they stand, with no HLO text to parse (the reference's ``_shape_bytes``
and its regexes have no counterpart).  Collective bytes follow the
reference's received-volume convention: each collective's output tensor,
weighted 1.0, under its keys (``all-gather``, ``reduce-scatter``,
``all-reduce``, ``all-to-all``, ``collective-permute``) and ``total``.

The byte counts are of the true dtypes, so ``dtype_factor`` is 1.0: the
reference halves bf16 traffic only because XLA:CPU promotes bf16 to f32
in the programs it counts.

MODEL_FLOPS = 6·N·D (training) or 2·N·D (inference forward), N the active
parameters; MODEL_FLOPS / counted FLOPs exposes recompute and dispatch
waste.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

from repro_torch.core.costmodel import H100

#: the reference's collective keys, each op weighted 1.0 (received bytes)
COLLECTIVE_KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
                    "collective-permute")
_OP_WEIGHT = {k: 1.0 for k in COLLECTIVE_KINDS}


def collective_bytes(records: Iterable[Tuple[str, float]]) -> Dict[str, float]:
    """Per-kind received bytes (per chip) of a step's collectives, given as
    (kind, output tensor bytes) pairs, with their ``total``."""
    out: Dict[str, float] = {}
    for kind, nbytes in records:
        out[kind] = out.get(kind, 0.0) + nbytes * _OP_WEIGHT[kind]
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float          # per chip
    hlo_bytes: float          # per chip (HBM traffic)
    coll_bytes: Dict[str, float]  # per chip
    model_flops: float        # global useful FLOPs (6ND / 2ND)
    peak_mem_bytes: Optional[float] = None
    # true dtypes are counted: nothing to scale (see the module docstring)
    dtype_factor: float = 1.0
    dtype: str = "bfloat16"   # compute dtype: picks the peak FLOP/s

    @property
    def peak_flops(self) -> float:
        return H100["peak_flops"][self.dtype]

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes * self.dtype_factor / H100["hbm_bw"]

    @property
    def t_collective(self) -> float:
        return self.coll_bytes.get("total", 0.0) * self.dtype_factor / H100["nvlink_bw"]

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def step_time(self) -> float:
        """Roofline lower bound on the step time (terms overlap-free)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline bound."""
        t = self.step_time
        if t <= 0:
            return 0.0
        return self.model_flops / self.chips / t / self.peak_flops

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops_per_chip": self.hlo_flops,
            "hlo_bytes_per_chip": self.hlo_bytes,
            "collective_bytes_per_chip": self.coll_bytes,
            "model_flops_global": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_ratio,
            "roofline_step_s": self.step_time,
            "roofline_mfu": self.mfu,
            "peak_mem_bytes_per_chip": self.peak_mem_bytes,
        }


def model_flops(cfg, shape_info: Dict, training: bool) -> float:
    """6·N·D (train) or 2·N·D (inference), N = active params."""
    n = cfg.param_count(active_only=True)
    if shape_info["mode"] == "train":
        tokens = shape_info["batch"] * shape_info["seq"]
        return 6.0 * n * tokens
    if shape_info["mode"] == "prefill":
        tokens = shape_info["batch"] * shape_info["seq"]
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape_info["batch"]
