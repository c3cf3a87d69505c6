"""Multi-pod dry run: every (arch x input shape x mesh) step, run once on
fake tensors and counted (counterpart of ``src/repro/launch/dryrun.py``).

For each combination this builds the step the shape exercises (the train
step with AdamW and its fp32 moments, the prefill, or the one-token
``serve_step``) from abstract inputs, lays it over the production mesh
with the HMP rules (``models/sharding.py``: ``DTensor``s over the fake
process group of ``launch/mesh.py``), runs it under ``FakeTensorMode``
(nothing is allocated) and a ``StepCounter`` (``roofline/counter.py``),
and records per-chip FLOPs, bytes, collectives and memory, priced on the
H100 by ``roofline/analysis.py``.

The reference lowers and compiles one jitted program and reads XLA's
analyses; here the step runs op by op and each op is counted where it
runs, so the full depth is counted directly: the reference's G=1/G=2
extrapolation and its analytic xLSTM scan correction have no counterpart
(they exist because XLA counts a loop body once).

The model runs on ``backend="eager"``: a fake tensor cannot enter a
kernel launch, and the reference's dry run lowers models that call no
Pallas kernel.  Constants the model makes (positions, masks, zeros) are
plain tensors; ``implicit_replication`` lets them enter ``DTensor`` ops
replicated, as GSPMD treats an unannotated constant.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--tp-only]
Results go to experiments/dryrun_torch/<arch>__<shape>__<mesh>.json.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import destroy_fake_group, make_mesh, production_shape
from repro_torch.launch.shapes import SHAPES, input_specs, shape_config
from repro_torch.models.params import abstract_params
from repro_torch.models.sharding import (Rules, abstract_tensor, axis_rules, make_rules,
                                         select_row)
from repro_torch.models.transformer import apply_model
from repro_torch.roofline.analysis import Roofline, collective_bytes, model_flops
from repro_torch.roofline.counter import StepCounter, local, tensor_bytes
from repro_torch.training.optimizer import AdamW, AdamWState, cosine_schedule
from repro_torch.training.train_loop import make_train_step

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def _info(shape) -> Dict:
    return SHAPES[shape] if isinstance(shape, str) else shape


def _moments(params: Dict, rules: Optional[Rules]) -> Dict:
    """fp32 fakes laid out as the params (AdamW's mu or nu)."""
    from repro_torch.models.params import _leaves, _set

    out: Dict = {}
    for path, p in _leaves(params):
        if hasattr(p, "placements"):
            from torch.distributed.tensor import DTensor

            lp = local(p)
            m = DTensor.from_local(torch.empty(lp.shape, dtype=torch.float32, device=lp.device),
                                   p.device_mesh, p.placements, run_check=False,
                                   shape=p.shape, stride=p.stride())
        else:
            m = abstract_tensor(p.shape, torch.float32)
        _set(out, path, m)
    return out


def build_step(cfg: ModelConfig, shape, rules: Optional[Rules]):
    """Returns (fn, params, state, batch): the step this shape exercises and
    its abstract arguments.  ``fn(params, state, batch)`` returns the step's
    outputs; ``state`` is the AdamW state in training, else None.
    ``shape``: a name of ``SHAPES`` or a dict of its seq, batch and mode."""
    info = _info(shape)
    mode = info["mode"]
    batch = input_specs(cfg, shape, rules)
    params = abstract_params(cfg, rules)

    if mode == "train":
        opt = AdamW(cosine_schedule(3e-4, 100, 10000))
        state = AdamWState(0, _moments(params, rules), _moments(params, rules))
        step = make_train_step(cfg, opt, rules, backend="eager")

        def train_step(params, state, batch):
            params, state, metrics = step(params, state, batch)
            return params, state, metrics["loss"]

        return train_step, params, state, batch

    if mode == "prefill":
        from repro_torch.serving.kvcache import make_cache

        batch = dict(batch, cache=make_cache(cfg, info["batch"], info["seq"], abstract=True,
                                             rules=rules))

        def prefill_step(params, state, batch):
            # every row's logits, then the last row's, as the reference's step
            with torch.no_grad(), axis_rules(rules):
                logits, cache = apply_model(params, cfg, mode="prefill", backend="eager",
                                            **batch)
                return select_row(logits, 1, info["seq"] - 1), cache

        return prefill_step, params, None, batch

    # decode / decode_long -> serve_step: ONE new token against the cache
    def serve_step(params, state, batch):
        with torch.no_grad(), axis_rules(rules):
            logits, cache = apply_model(params, cfg, mode="decode", backend="eager", **batch)
        return logits[:, -1], cache

    return serve_step, params, None, batch


def _tree_bytes(tree) -> int:
    from torch.utils._pytree import tree_flatten

    return sum(tensor_bytes(local(t)) for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def count_step(cfg: ModelConfig, shape, rules: Optional[Rules]) -> Dict:
    """Build and run one step on fake tensors under a ``StepCounter``;
    returns the counter and the step's byte and time figures."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    t0 = time.perf_counter()
    with FakeTensorMode():
        fn, params, state, batch = build_step(cfg, shape, rules)
        arg_bytes = _tree_bytes(params) + (
            _tree_bytes([state.mu, state.nu]) if state is not None else 0)
        in_bytes = _tree_bytes(batch)
        t_build = time.perf_counter() - t0
        counter = StepCounter()
        counter.track((params, state, batch))
        t1 = time.perf_counter()
        with counter, implicit_replication():
            out = fn(params, state, batch)
        t_count = time.perf_counter() - t1
        out_bytes = _tree_bytes(out)
    del out, params, state, batch
    return dict(counter=counter, argument_bytes=arg_bytes, input_bytes=in_bytes,
                output_bytes=out_bytes, build_s=t_build, count_s=t_count)


def run_one(arch: str, shape: str, *, multi_pod: bool = False,
            hmp_sequence_parallel: bool = True, save: bool = True,
            verbose: bool = True, variant: str = "",
            cfg_overrides: Optional[dict] = None,
            rules_overrides: Optional[dict] = None,
            mesh_shape: Optional[Sequence[int]] = None,
            shape_info: Optional[dict] = None) -> dict:
    """One dry run; returns (and with ``save`` writes) its record.
    ``variant`` tags the output file; ``cfg_overrides`` are
    ``dataclasses.replace`` fields; ``rules_overrides`` extra
    ``make_rules`` arguments.  ``mesh_shape`` replaces the production mesh
    ((data, model), or (pod, data, model)); ``shape_info`` (seq, batch,
    mode) replaces the named shape's, which then only names the record."""
    if mesh_shape is None:
        dims, axes = production_shape(multi_pod)
    else:
        dims = tuple(mesh_shape)
        axes = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
        multi_pod = len(dims) == 3
    mesh = make_mesh(dims, axes)
    mesh_name = "x".join(str(s) for s in dims)
    chips = mesh.size()

    cfg = shape_config(get_config(arch), shape) if shape in SHAPES else get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    info = shape_info or SHAPES[shape]
    rules = make_rules(mesh, info["mode"], multi_pod=multi_pod, batch_size=info["batch"],
                       hmp_sequence_parallel=hmp_sequence_parallel,
                       **(rules_overrides or {}))

    res = count_step(cfg, info, rules)
    counter = res["counter"]
    coll = collective_bytes(counter.collectives.items())
    rl = Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=counter.flops, hlo_bytes=counter.bytes, coll_bytes=coll,
        model_flops=model_flops(cfg, info, training=info["mode"] == "train"),
        peak_mem_bytes=counter.peak_bytes, dtype=cfg.dtype,
    )
    record = rl.to_dict()
    record.update(
        hmp_sequence_parallel=hmp_sequence_parallel,
        dtype=cfg.dtype,
        seq=info["seq"], batch=info["batch"], mode=info["mode"],
        lower_s=round(res["build_s"], 3),     # building the abstract arguments
        compile_s=None,                       # nothing is compiled
        count_s=round(res["count_s"], 3),     # the counted fake run
        argument_bytes=res["argument_bytes"],  # params (+ AdamW's fp32 moments), per chip
        input_bytes=res["input_bytes"],        # tokens, labels, cache, per chip
        output_bytes=res["output_bytes"],
        temp_bytes=max(0, counter.peak_bytes - res["argument_bytes"] - res["input_bytes"]),
        generated_code_bytes=None,
        flops_by_op=counter.by_op,
        bytes_by_op=counter.bytes_by_op,
    )
    if save:
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        suffix = "" if hmp_sequence_parallel else "__tp_only"
        if variant:
            suffix += f"__{variant}"
        path = OUT_DIR / f"{arch}__{shape}__{mesh_name}{suffix}.json"
        path.write_text(json.dumps(record, indent=2))
    if verbose:
        print(f"[dryrun] {arch:24s} {shape:12s} mesh={mesh_name:9s} OK "
              f"flops/chip={record['hlo_flops_per_chip']:.3e} "
              f"bytes/chip={record['hlo_bytes_per_chip']:.3e} "
              f"coll/chip={coll.get('total', 0) / 1e6:.1f}MB "
              f"peak/chip={counter.peak_bytes / 1e9:.2f}GB "
              f"bottleneck={record['bottleneck']} "
              f"useful={record['useful_flops_ratio']:.3f} "
              f"(build {res['build_s']:.1f}s count {res['count_s']:.1f}s)", flush=True)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=list(ASSIGNED_ARCHS) + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--tp-only", action="store_true",
                    help="disable HMP sequence parallelism (Megatron-TP baseline)")
    ap.add_argument("--continue-on-error", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="skip combos whose result JSON already exists")
    args = ap.parse_args(argv)

    archs = list(ASSIGNED_ARCHS) if args.all or args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape is None else [args.shape]
    # smallest archs first: early results bank fast
    archs.sort(key=lambda a: get_config(a).param_count())

    mesh_name = "x".join(str(s) for s in production_shape(args.multi_pod)[0])
    failures = []
    t0 = time.perf_counter()
    try:
        for arch in archs:
            for shape in shapes:
                suffix = "__tp_only" if args.tp_only else ""
                path = OUT_DIR / f"{arch}__{shape}__{mesh_name}{suffix}.json"
                if args.resume and path.exists():
                    print(f"[dryrun] {arch} {shape} {mesh_name} cached, skipping", flush=True)
                    continue
                try:
                    run_one(arch, shape, multi_pod=args.multi_pod,
                            hmp_sequence_parallel=not args.tp_only)
                except Exception as e:  # noqa: BLE001 - the sweep reports and goes on
                    failures.append((arch, shape, repr(e)))
                    print(f"[dryrun] {arch} {shape} FAILED: {e}", flush=True)
                    if not args.continue_on_error:
                        traceback.print_exc()
                        raise
    finally:
        destroy_fake_group()
    print(f"[dryrun] wall {time.perf_counter() - t0:.1f} s", flush=True)
    if failures:
        print(f"{len(failures)} failures:", *failures, sep="\n  ")
        raise SystemExit(1)
    print("all dry-runs passed")


if __name__ == "__main__":
    main()
