"""Where a fused-connective launch spends its time: the kernel built with
parts cut out, each timed at the served shapes.

  python src/repro_torch/launch/connective_breakdown.py [--iters N]

Builds variants of ``kernels/csrc/fused_connective.cu`` with ``nvcc`` into
``kernels/_build/breakdown_connective/`` and launches each through the
wrapper's C interface on the register-row path ("warp"), timing the mean
of ``--iters`` launches behind a device sleep.  Shapes, fp16, d 1280:
``site``, the four 57-row shards of a GPT2-L connective site on the
3:2:2:1 plan in one launch, and ``shard``, one of them alone.  Variants
(their outputs are wrong by design; only their times mean something):

- ``full``: the kernel as it is;
- ``empty``: every warp returns at once (the launch and its parameters
  alone);
- ``shard0_descriptor``: every warp reads shard 0's descriptor at a fixed
  offset, not its own shard's at a computed one;
- ``no_scale_bias``: scale 1 and bias 0 instead of their loads;
- ``no_row_loads``: x and the residual made up in registers instead of
  loaded;

and other designs, timed beside it:

- ``late_scale_bias``: scale and bias loaded after the reductions, where
  the output needs them, as rows wider than 1280 do (the first design);
- ``rows1``, ``rows2``: blocks of one or two rows, not four, so the rows
  spread over more SMs.

Prints the card's name and power limit, then one JSON line of
microseconds per shape and variant.  Needs a CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[2]
CU = "fused_connective.cu"
# (file, old, new) edits of each variant
EARLY_LOADS = (CU, "      if constexpr (EARLY) {\n        sraw[v] = load16(scale + c);\n"
                   "        braw[v] = load16(bias + c);\n      }\n", "")
UNPACK = "        unpack<T, V>(sraw[v], sv);\n        unpack<T, V>(braw[v], bv);\n"
VARIANTS = {
    "full": [],
    "empty": [(CU, "  if (row >= total) return;\n", "  if (row >= 0) return;\n")],
    "shard0_descriptor": [(CU, "  const Shard& sh = g.sh[j];\n",
                           "  const Shard& sh = g.sh[0];\n")],
    "no_scale_bias": [EARLY_LOADS, (CU, UNPACK, "#pragma unroll\n        for (int e = 0; e < V; "
                                                "++e) sv[e] = 1.f, bv[e] = 0.f;\n")],
    "no_row_loads": [(CU, "      load_vec<T, V>(x + c, xv);\n      load_vec<T, V>(res + c, rv);\n",
                      "#pragma unroll\n"
                      "      for (int e = 0; e < V; ++e) xv[e] = c + e, rv[e] = lane;\n")],
    "late_scale_bias": [EARLY_LOADS, (CU, UNPACK, "        load_vec<T, V>(scale + c, sv);\n"
                                                  "        load_vec<T, V>(bias + c, bv);\n")],
    "rows1": [(CU, "constexpr int WARPS = 4;", "constexpr int WARPS = 1;")],
    "rows2": [(CU, "constexpr int WARPS = 4;", "constexpr int WARPS = 2;")],
}
#: rows a block of the variants that change it (the others: the kernel's)
ROWS_A_BLOCK = {"rows1": 1, "rows2": 2}
SHAPES = {"site": (57, 57, 57, 57), "shard": (57,)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(SRC))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch

    if not torch.cuda.is_available():
        print("connective_breakdown: needs a CUDA device", file=sys.stderr)
        return 2
    from kernel_timing import build_variants, card_line, time_ms
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_connective as fc

    card = card_line()
    libs = build_variants(build, "fused_connective", VARIANTS,
                          build.BUILD_DIR / "breakdown_connective")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    d, res = 1280, {}
    for key, rows in SHAPES.items():
        ts = [[torch.randn(r, d, generator=g, device=dev).half() for r in rows]
              for _ in range(3)]
        scales = [torch.ones(d, device=dev).half() for _ in rows]
        biases = [torch.zeros(d, device=dev).half() for _ in rows]
        desc = []
        for x, r, out, sc, bi in zip(*ts, scales, biases):
            desc += [x.data_ptr(), r.data_ptr(), x.data_ptr(), out.data_ptr(), sc.data_ptr(),
                     bi.data_ptr(), d, d, d, d]
        (launch,) = fc.pack_group(rows)
        desc_arr = (ctypes.c_longlong * len(desc))(*desc)
        row0 = (ctypes.c_int * len(launch.row0))(*launch.row0)
        for name, path in libs.items():
            fn = ctypes.CDLL(str(path)).fused_connective
            fn.restype, fn.argtypes = fc._SIGNATURES["fused_connective"]

            per = ROWS_A_BLOCK.get(name, fc.ROWS_PER_BLOCK)
            blocks = -(-launch.row0[-1] // per)

            def run():
                build.check(fn(2, fc._PATHS["warp"], desc_arr, row0, len(rows), d, 0, 1.0,
                               1e-5, launch.row0[-1], blocks, stream), name)
            res[f"{key}/{name}"] = round(1e3 * time_ms(run, args.iters), 2)
    print(card)
    print(json.dumps({"us": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
