"""Galaxy Profiler (paper §III-A step 1), analytic backend.

``AnalyticProfiler`` turns the calibrated cost model into the traces the
planner consumes: per-device capacity V_d (Eq. 6), per-block memory
footprints (M_att, M_mlp), and the per-row costs of the sequence axis.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.core import costmodel, planner
from repro_torch.core.costmodel import DeviceSpec
from repro_torch.core.planner import DeviceProfile, ModelProfile


class AnalyticProfiler:
    def __init__(self, cfg: ModelConfig, seq: int):
        self.cfg = cfg
        self.seq = seq
        self.prof = costmodel.layer_profile(cfg, seq)

    def capacity(self, dev: DeviceSpec) -> float:
        """V_d per Eq. 6 (1/seconds for the full MHA+MLP blocks)."""
        t = (self.prof["mha_flops"] + self.prof["mlp_flops"]) / dev.flops
        return 1.0 / t

    def device_profiles(self, devices: Sequence[DeviceSpec]) -> List[DeviceProfile]:
        return [
            DeviceProfile(d.name, self.capacity(d), d.memory_budget) for d in devices
        ]

    def model_profile(self) -> ModelProfile:
        cfg = self.cfg
        return ModelProfile(
            name=cfg.name,
            num_layers=cfg.num_layers,
            num_heads=cfg.num_heads,
            mlp_columns=cfg.d_ff,
            m_att=self.prof["m_att"],
            m_mlp=self.prof["m_mlp"],
        )

    def seq_cost_args(self, devices: Sequence[DeviceSpec]) -> Dict[str, object]:
        """Per-row costs of the SP axis, for ``planner.sequence_partition``:
        activation bytes one row moves per ring hop, and the seconds of
        (memory-bandwidth-bound) connective work one row costs per device."""
        return {
            "unit_bytes": self.prof["act_bytes"] / self.seq,
            "unit_con_time": [
                (self.prof["con_bytes"] / self.seq) / d.mem_bw for d in devices
            ],
        }

    def plan(self, devices: Sequence[DeviceSpec], links=None,
             pad_penalty: float = 0.0) -> planner.Plan:
        """Run Algorithm 1 from this profile; with per-device ``links`` the
        SP axis is solved bandwidth-aware over this profiler's sequence
        length (ragged sequence tiles)."""
        kwargs = {}
        if links is not None:
            kwargs = dict(seq_units=self.seq, **self.seq_cost_args(devices))
        return planner.plan(self.model_profile(), self.device_profiles(devices),
                            links, pad_penalty=pad_penalty, **kwargs)
