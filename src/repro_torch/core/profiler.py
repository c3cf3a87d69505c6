"""Galaxy Profiler (paper §III-A step 1).

Produces the traces the planner consumes: per-device capacity V_d
(Eq. 6), per-block memory footprints (M_att, M_mlp), and the per-row
costs of the sequence axis.  Two backends:

- ``AnalyticProfiler``: the calibrated cost model (simulated edge
  clusters; the planner and the simulator read it).
- ``HostProfiler``: times the MHA, MLP and connective blocks in plain
  torch ops on a real device (the card by default), as the paper's
  profiler runs on the physical devices.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Sequence

import torch

from repro_torch import resolve_device
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


class HostProfiler:
    """Times the MHA, MLP and connective blocks of ``cfg`` at ``seq`` rows
    in plain torch ops, fp32 with TF32 off, on ``device`` (``cuda`` unless
    the caller asks for another).  Inputs are drawn from a generator
    seeded with 0.  On CUDA a block is called once to warm up, then
    ``iters`` calls run between two ``torch.cuda.synchronize()``, so the
    time is the device's and not the host's dispatch."""

    def __init__(self, cfg: ModelConfig, seq: int, iters: int = 5, *, device=None):
        self.cfg = cfg
        self.seq = seq
        self.iters = iters
        self.device = resolve_device(device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _time(self, fn, *args) -> float:
        fn(*args)
        self._sync()
        t0 = time.perf_counter()
        for _ in range(self.iters):
            fn(*args)
        self._sync()
        return (time.perf_counter() - t0) / self.iters

    def measure_blocks(self, heads: int, columns: int) -> Dict[str, float]:
        """Measured L(MHA, a, device), L(MLP, b, device), L(CON, full,
        device), in seconds."""
        cfg, s = self.cfg, self.seq
        d, hd = cfg.d_model, cfg.head_dim
        gen = torch.Generator(device=self.device).manual_seed(0)

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=self.device)

        x = randn(1, s, d)
        wqkv = randn(d, 3 * heads * hd)
        wo = randn(heads * hd, d)
        w1 = randn(d, columns)
        w2 = randn(columns, d)

        def mha(x, wqkv, wo):
            q, k, v = (x @ wqkv).split(heads * hd, -1)
            q, k, v = (t.reshape(1, s, heads, hd) for t in (q, k, v))
            sc = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(hd)
            o = torch.einsum("bhst,bthd->bshd", sc.softmax(-1), v)
            return o.reshape(1, s, heads * hd) @ wo

        def mlp(x, w1, w2):
            return torch.nn.functional.gelu(x @ w1) @ w2

        def con(x):
            mu = x.mean(-1, keepdim=True)
            var = ((x - mu) ** 2).mean(-1, keepdim=True)
            return x + (x - mu) * torch.rsqrt(var + 1e-5)

        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            with torch.no_grad():
                return {
                    "mha": self._time(mha, x, wqkv, wo),
                    "mlp": self._time(mlp, x, w1, w2),
                    "con": self._time(con, x),
                }
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    def capacity(self) -> float:
        """V_d (Eq. 6) of this device: 1 / (L(MHA, full) + L(MLP, full))."""
        t = self.measure_blocks(self.cfg.num_heads, self.cfg.d_ff)
        return 1.0 / (t["mha"] + t["mlp"])
