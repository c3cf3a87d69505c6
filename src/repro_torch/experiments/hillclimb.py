"""§Perf hillclimbs on the dry run (counterpart of the reference's
``experiments/hillclimb.py``): the three chosen (arch x shape) pairs, each
variant counted again on the single-pod production mesh (16 x 16) and
saved as a tagged record beside its baseline.

Pairs (chosen by the reference from its 40-combination baseline table):
  1. granite-moe-3b-a800m / train_4k: the worst roofline MFU; remat
     "dots", then capacity factor 1.25, then query-chunked attention
  2. qwen1.5-110b / decode_32k: the most collective-bound; serving weights
     sharded on the model axis only, then fp8 weights
  3. codeqwen1.5-7b / prefill_32k: the most paper-representative (one-shot
     prefill); query-chunked attention, and the TP-only layout beside HMP

Each variant's baseline is the run it changes one thing of (``RUNS``): the
plain pair for the first of a chain, the previous variant after that.
Records go to ``experiments/dryrun_torch/<arch>__<shape>__16x16__<tag>.json``
(the plain pairs without a tag, as the sweep writes them) with their
``variant`` and ``baseline`` tags; ``python -m repro_torch.roofline.report
16x16 --variants`` tables each variant beside its baseline.  Unlike the
reference, a variant that fails is printed, the others run, and the
script exits non-zero.

:func:`coordinate_hillclimb` is the generic multiplicative coordinate
descent ``experiments/calibrate.py`` fits the cost model with.

Usage: PYTHONPATH=src python -m repro_torch.experiments.hillclimb [tag-substring]
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Optional, Tuple

#: (arch, shape, tag, cfg overrides, rules overrides, baseline tag); the
#: tag "tp_only" is the Megatron-TP layout (no HMP sequence parallelism)
RUNS = [
    # --- 1. granite-moe train_4k
    ("granite-moe-3b-a800m", "train_4k", "h1a_remat_dots",
     dict(remat_policy="dots"), {}, ""),
    ("granite-moe-3b-a800m", "train_4k", "h1b_cf125",
     dict(remat_policy="dots", moe_capacity_factor=1.25), {}, "h1a_remat_dots"),
    ("granite-moe-3b-a800m", "train_4k", "h1c_attnchunk",
     dict(remat_policy="dots", moe_capacity_factor=1.25, attn_chunk=1024), {}, "h1b_cf125"),
    # --- 2. qwen1.5-110b decode_32k
    ("qwen1.5-110b", "decode_32k", "h2a_weights_model_only",
     {}, dict(serve_weights_model_only=True), ""),
    ("qwen1.5-110b", "decode_32k", "h2b_fp8_weights",
     dict(param_dtype="float8_e4m3fn"), dict(serve_weights_model_only=True),
     "h2a_weights_model_only"),
    # --- 3. codeqwen prefill_32k
    ("codeqwen1.5-7b", "prefill_32k", "h3a_attnchunk", dict(attn_chunk=2048), {}, ""),
    # the paper-faithful comparison: the Megatron-TP layout on the same pair
    ("codeqwen1.5-7b", "prefill_32k", "tp_only", {}, {}, ""),
]


def coordinate_hillclimb(loss_fn: Callable[[Dict[str, float]], float],
                         params: Dict[str, float], *,
                         factors=(0.5, 0.8, 1.25, 2.0), rounds: int = 8,
                         verbose: bool = False) -> Tuple[Dict[str, float], float]:
    """Multiplicative coordinate descent over named scalar params.

    Tries scaling each parameter by each factor, keeping any move that
    lowers ``loss_fn(params)``; stops after ``rounds`` sweeps or when no
    single move improves.  Returns ``(best_params, best_loss)``."""
    best = dict(params)
    best_loss = loss_fn(best)
    for _ in range(rounds):
        improved = False
        for name in list(best):
            for f in factors:
                cand = dict(best)
                cand[name] = best[name] * f
                loss = loss_fn(cand)
                if loss < best_loss - 1e-12:
                    best, best_loss, improved = cand, loss, True
                    if verbose:
                        print(f"  {name} x{f} -> loss {loss:.4f}", flush=True)
        if not improved:
            break
    return best, best_loss


def report(tag: str, r: Dict) -> str:
    """One record as the reference's hillclimb line."""
    return (f"[{tag}] tc={r['t_compute_s']:.4f} tm={r['t_memory_s']:.4f} "
            f"tcoll={r['t_collective_s']:.4f} bneck={r['bottleneck']} "
            f"useful={r['useful_flops_ratio']:.2f} mfu={r['roofline_mfu']:.3f} "
            f"temp={(r['temp_bytes'] or 0) / 1e9:.1f}GB "
            f"args={(r['argument_bytes'] or 0) / 1e9:.1f}GB "
            f"flops/chip={r['hlo_flops_per_chip']:.4e} "
            f"peak/chip={(r['peak_mem_bytes_per_chip'] or 0) / 1e9:.3f}GB")


def _baselines(runs) -> List[Tuple[str, str]]:
    """The plain (arch, shape) pairs the runs' chains start from."""
    out = []
    for arch, shape, *_ in runs:
        if (arch, shape) not in out:
            out.append((arch, shape))
    return out


def run(only: str = "", *, save: bool = True, num_layers: Optional[int] = None,
        log: Callable[[str], None] = print) -> Tuple[Dict[Tuple[str, str, str], Dict], List]:
    """Count the plain pairs, then the variants whose tag contains
    ``only`` (all for ""), on the 16 x 16 mesh.  ``num_layers`` cuts every
    run to that depth (the same cut on both sides of each comparison).
    Returns ``(records, failures)``: records by (arch, shape, tag), tag ""
    for a plain pair; failures as (tag, error) pairs."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import destroy_fake_group

    runs = [r for r in RUNS if not only or only in r[2]]
    depth = {} if num_layers is None else {"num_layers": num_layers}
    records: Dict[Tuple[str, str, str], Dict] = {}
    failures = []
    jobs = [(arch, shape, "", {}, {}, None) for arch, shape in _baselines(runs)] + runs
    try:
        for arch, shape, tag, cfg_over, rules_over, base in jobs:
            t0 = time.perf_counter()
            try:
                r = dryrun.run_one(arch, shape, save=False, verbose=False,
                                   variant="" if tag == "tp_only" else tag,
                                   hmp_sequence_parallel=tag != "tp_only",
                                   cfg_overrides={**cfg_over, **depth},
                                   rules_overrides=rules_over)
            except Exception as e:  # noqa: BLE001 - reported, the others still run
                failures.append((tag or f"{arch}/{shape}", f"{type(e).__name__}: {e}"))
                log(f"[{arch}/{shape}/{tag or 'baseline'}] FAILED: {type(e).__name__}: "
                    f"{str(e)[:300]}")
                continue
            r.update(variant=tag, baseline=base, cfg_overrides=cfg_over,
                     rules_overrides=rules_over, num_layers_cut=num_layers)
            records[(arch, shape, tag)] = r
            log(report(f"{arch}/{shape}/{tag or 'baseline'}", r)
                + f" ({time.perf_counter() - t0:.1f}s)")
            if save:
                _save(r)
    finally:
        destroy_fake_group()
    return records, failures


def _save(r: Dict) -> None:
    from repro_torch.launch.dryrun import OUT_DIR

    suffix = f"__{r['variant']}" if r["variant"] else ""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path = OUT_DIR / f"{r['arch']}__{r['shape']}__{r['mesh']}{suffix}.json"
    path.write_text(json.dumps(r, indent=2))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("only", nargs="?", default="",
                    help="run only the variants whose tag contains this")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    records, failures = run(args.only)
    print(f"[hillclimb] {len(records)} records in {time.perf_counter() - t0:.1f} s", flush=True)
    if failures:
        print(f"{len(failures)} failed:", *(f"{t}: {e}" for t, e in failures), sep="\n  ")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
