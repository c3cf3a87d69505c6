"""Heterogeneity- and memory-aware planning (paper Alg. 1) end to end:
profile -> plan -> simulate, on the paper's own edge environments.  Pure
numpy: no device is used.

    PYTHONPATH=src python -m repro_torch.examples.plan_heterogeneous
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.core import costmodel as cm
from repro_torch.core import planner
from repro_torch.core import simulator as sim
from repro_torch.core.profiler import AnalyticProfiler

SEQ = 284  # the paper's Bert-L sequence


def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    cfg = get_config("bert-l")
    out = {}
    for env_id in ("C", "D", "E", "F"):
        devices = cm.edge_env(env_id)
        prof = AnalyticProfiler(cfg, seq=SEQ)
        model_profile = prof.model_profile()
        plan = planner.plan(model_profile, prof.device_profiles(devices))

        names = "+".join(d.name for d in devices)
        print(f"\nenv {env_id} ({names}):")
        if not plan.feasible:
            print(f"  INFEASIBLE: {plan.reason}")
            out[env_id] = None
            continue
        mem = plan.memory_per_device(model_profile)
        for i, d in enumerate(devices):
            print(f"  {d.name:9s} heads={int(plan.mha[i]):2d}/{cfg.num_heads} "
                  f"mlp_cols={int(plan.mlp[i]):4d}/{cfg.d_ff} "
                  f"seq={plan.seq[i] * 100:.0f}%  mem={mem[i] / 1e6:.0f}MB "
                  f"(budget {d.memory_budget / 1e6:.0f}MB)")
        t = sim.speedup_table(cfg, devices, cm.mbps(125), SEQ)
        f = lambda v: v if isinstance(v, str) else f"{v:.2f}x"  # noqa: E731
        print(f"  galaxy latency {t['galaxy_s']:.2f}s | "
              f"vs Megatron-LM {f(t['megatron'])} | vs SP {f(t['sp'])}")
        out[env_id] = t
    return out


if __name__ == "__main__":
    main()
