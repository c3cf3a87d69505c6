"""Where a train step's time goes: training steps under ``torch.profiler``.

  PYTHONPATH=src python -m repro_torch.launch.trace_train --arch qwen1.5-0.5b
  PYTHONPATH=src python -m repro_torch.launch.trace_train --arch musicgen-medium

Draws the model once (random weights, seed 0) and runs ``launch.train``
three times on the same weights: 3 steps to build and warm the kernels
and cuBLAS, ``--steps`` steps unprofiled for the wall time, and
``--steps`` steps under the profiler for the device time by kernel and by
operator (an operator's own launches; the hand-written kernels launch
outside any operator and show only as kernels).  Prints the per-step
wall (unprofiled and profiled), the device-busy time per step and the
idle share, the launches per step, and the kernels and operators that
took the most device time.  The profiler adds host time, so the idle
share against the unprofiled wall is the closer estimate.  Runs on
``cuda`` unless ``--device cpu`` is given (where no device time is
recorded); ``--reduce`` trains the model's small variant.
"""
from __future__ import annotations

import argparse
from typing import Dict

import torch

from repro_torch import resolve_device
from repro_torch.configs import ASSIGNED_ARCHS, ModelConfig, get_config, reduced
from repro_torch.launch.train import check_fits_one_card, train
from repro_torch.models.params import init_params


def trace(cfg: ModelConfig, *, steps: int = 5, warm: int = 3, batch: int = 8,
          seq: int = 128, device=None) -> Dict:
    """Warm, then unprofiled, then profiled steps on one set of weights;
    returns per-step wall ms, device-busy ms per step, launches per step
    and the profiler's device-side events."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    kw = dict(batch=batch, seq=seq, device=dev, params=params, log=lambda m: None)
    train(cfg, steps=warm, **kw)
    plain = train(cfg, steps=steps, **kw)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        traced = train(cfg, steps=steps, **kw)
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    return {
        "step_ms": 1e3 * plain["seconds"] / steps,
        "median_step_ms": 1e3 * plain["median_step_s"],
        "profiled_step_ms": 1e3 * traced["seconds"] / steps,
        "busy_ms": sum(e.device_time_total for e in kernels) / 1e3 / steps,
        "launches": sum(e.count for e in kernels) / steps,
        "kernels": sorted(kernels, key=lambda e: -e.device_time_total),
        "ops": sorted(ops, key=lambda e: -e.self_device_time_total),
        "peak_bytes": plain["peak_bytes"],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=ASSIGNED_ARCHS)
    ap.add_argument("--reduce", action="store_true")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduced(cfg)
    else:
        check_fits_one_card(cfg)
    out = trace(cfg, steps=args.steps, batch=args.batch, seq=args.seq, device=args.device)
    head = (f"{cfg.name}: {cfg.num_layers} layers, {cfg.dtype}, remat {cfg.remat}, "
            f"{args.batch} x {args.seq} tokens: step "
            f"{out['step_ms']:.2f} ms unprofiled (median {out['median_step_ms']:.2f}), "
            f"{out['profiled_step_ms']:.2f} ms profiled")
    kernels = out["kernels"]
    if not kernels:
        print(f"{head}; device busy: not measured (no device activity recorded)")
        return out
    busy = out["busy_ms"]
    print(f"{head}; device busy {busy:.2f} ms a step in {out['launches']:.0f} launches; "
          f"idle {100 * (1 - busy / out['step_ms']):.1f}% of the unprofiled step, "
          f"{100 * (1 - busy / out['profiled_step_ms']):.1f}% of the profiled; peak "
          f"memory {out['peak_bytes'] / 2**30:.2f} GiB")
    for e in kernels[:args.top]:
        print(f"  {e.device_time_total / 1e3 / args.steps:9.3f} ms {e.count // args.steps:6d}x"
              f"  {e.key[:90]}")
    print("operators by the device time of their own launches, a step:")
    for e in out["ops"][:args.top]:
        print(f"  {e.self_device_time_total / 1e3 / args.steps:9.3f} ms "
              f"{e.count // args.steps:6d}x  {e.key[:90]}")
    return out


if __name__ == "__main__":
    main()
