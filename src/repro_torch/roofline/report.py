"""Tables of the dry run's records (counterpart of
``experiments/make_report.py``): the roofline table and the collective
mix per (arch x shape) of one mesh, from the JSONs ``launch/dryrun.py``
writes under ``experiments/dryrun_torch/``.  The records carry the
reference's keys, so the columns are the reference report's; the
per-chip peak memory column reads ``peak_mem_bytes_per_chip`` (the
reference reads XLA's temp bytes) and times are priced on the H100.
``--variants`` tables the hillclimb's records (``experiments/
hillclimb.py``), each variant beside the baseline it changes one thing of.

Usage: PYTHONPATH=src python -m repro_torch.roofline.report [mesh] [--dir DIR] [--variants]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.launch.dryrun import OUT_DIR

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(mesh: str, suffix: str = "", directory: Optional[Path] = None) -> List[Dict]:
    """The records of ``mesh`` (and a variant ``suffix``), by arch and shape."""
    rows = []
    for p in sorted(Path(directory or OUT_DIR).glob(f"*__{mesh}{suffix}.json")):
        if suffix == "" and "__tp_only" in p.name:
            continue
        rows.append(json.loads(p.read_text()))
    rows.sort(key=lambda r: (r["arch"], SHAPE_ORDER.index(r["shape"])
                             if r["shape"] in SHAPE_ORDER else len(SHAPE_ORDER)))
    return rows


def roofline_table(rows: List[Dict]) -> str:
    out = [
        "| arch | shape | t_compute (s) | t_memory (s) | t_collective (s) "
        "| bottleneck | 6ND/counted | roofline MFU | peak GB/chip | counted in (s) |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.4g} "
            f"| {r['t_memory_s']:.4g} | {r['t_collective_s']:.4g} "
            f"| **{r['bottleneck']}** | {r['useful_flops_ratio']:.3f} "
            f"| {r['roofline_mfu']:.4f} | {(r['peak_mem_bytes_per_chip'] or 0) / 1e9:.2f} "
            f"| {r.get('count_s', float('nan')):.1f} |"
        )
    return "\n".join(out)


def collective_mix(rows: List[Dict]) -> str:
    out = ["| arch | shape | AG MB | RS MB | AR MB | A2A MB | total MB |",
           "|---|---|---|---|---|---|---|"]
    for r in rows:
        c = r["collective_bytes_per_chip"]
        out.append(
            "| {arch} | {shape} | {ag:.0f} | {rs:.0f} | {ar:.0f} | {a2a:.0f} | {tot:.0f} |".format(
                arch=r["arch"], shape=r["shape"],
                ag=c.get("all-gather", 0) / 1e6, rs=c.get("reduce-scatter", 0) / 1e6,
                ar=c.get("all-reduce", 0) / 1e6, a2a=c.get("all-to-all", 0) / 1e6,
                tot=c.get("total", 0) / 1e6,
            )
        )
    return "\n".join(out)


def load_variants(mesh: str, directory: Optional[Path] = None) -> List[Dict]:
    """The hillclimb's variant records of ``mesh`` (those with a
    ``variant`` tag), in file order."""
    rows = []
    for p in sorted(Path(directory or OUT_DIR).glob(f"*__{mesh}__*.json")):
        r = json.loads(p.read_text())
        if r.get("variant"):
            rows.append(r)
    return rows


#: the variants table's compared columns: (heading, value of a record, format)
_VARIANT_COLUMNS = [
    ("FLOPs/chip", lambda r: r["hlo_flops_per_chip"], "{:.4g}"),
    ("bytes/chip", lambda r: r["hlo_bytes_per_chip"], "{:.4g}"),
    ("collective GB/chip", lambda r: r["collective_bytes_per_chip"].get("total", 0) / 1e9,
     "{:.2f}"),
    ("peak GB/chip", lambda r: (r["peak_mem_bytes_per_chip"] or 0) / 1e9, "{:.2f}"),
    ("roofline step (s)", lambda r: r["roofline_step_s"], "{:.4g}"),
    ("bottleneck", lambda r: r["bottleneck"], "{}"),
]


def variants_table(variants: List[Dict], records: List[Dict]) -> str:
    """Each variant beside its baseline (``records`` and ``variants`` hold
    both): per-chip FLOPs, bytes, collective bytes and peak memory, the
    roofline step time and its bottleneck, baseline -> variant ("?" for a
    baseline not among the records)."""
    by_tag = {(r["arch"], r["shape"], r.get("variant") or ""): r for r in records + variants}
    heads = " | ".join(h for h, _, _ in _VARIANT_COLUMNS)
    out = [f"| arch | shape | variant | baseline | {heads} |",
           "|---" * (4 + len(_VARIANT_COLUMNS)) + "|"]
    for v in variants:
        b = by_tag.get((v["arch"], v["shape"], v.get("baseline") or ""))
        cells = [f"{'?' if b is None else fmt.format(get(b))} -> {fmt.format(get(v))}"
                 for _, get, fmt in _VARIANT_COLUMNS]
        out.append(f"| {v['arch']} | {v['shape']} | {v['variant']} | "
                   f"{v.get('baseline') or 'plain'} | " + " | ".join(cells) + " |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mesh", nargs="?", default="16x16")
    ap.add_argument("--dir", default=None, help=f"records' directory (default {OUT_DIR})")
    ap.add_argument("--variants", action="store_true",
                    help="the hillclimb's variants beside their baselines")
    args = ap.parse_args(argv)
    rows = load(args.mesh, directory=args.dir)
    if args.variants:
        print(variants_table(load_variants(args.mesh, directory=args.dir), rows))
        return
    print(roofline_table(rows))
    print()
    print(collective_mix(rows))


if __name__ == "__main__":
    main()
