"""Where a valid-length GEMM launch spends its time: the kernel built with
parts cut out, each timed at the served shapes.

  python src/repro_torch/launch/gemm_breakdown.py [--iters N]

Builds variants of ``kernels/csrc/tiled_gemm_valid.cu`` with ``nvcc`` into
``kernels/_build/breakdown/`` and launches each through the wrapper's C
interface on the plan ``plan_valid_gemm`` gives (and on one slice, no
split), timing the mean of ``--iters`` launches behind a device sleep,
with cold weights as in ``gemm_times.py``.  Variants (their outputs are
wrong by design; only their times mean something):

- ``full``: the kernel as it is;
- ``empty``: every block returns at once (the launch alone);
- ``no_reduce``: blocks return after their arrival: no reduction and no
  epilogue of split tiles;
- ``no_split_sums``: no partials, no arrival, no reduction: every block
  writes its own epilogue (racing);
- ``no_loads``: no K steps: partials, arrival, reduction and epilogue only.

Prints the card's name and power limit, then one JSON line of
microseconds per shape.  Needs a CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[2]
CU = "tiled_gemm_valid.cu"
# (file, old, new) edits of each variant
VARIANTS = {
    "full": [],
    "empty": [(CU, "  const int z = blockIdx.x, tile_n = blockIdx.y, tile_m = blockIdx.z;\n",
               "  const int z = blockIdx.x, tile_n = blockIdx.y, tile_m = blockIdx.z;\n"
               "  if (p.m > 0) return;\n")],
    "no_reduce": [(CU, "    if (!is_last) return;\n", "    return;\n")],
    "no_split_sums": [(CU, "  if (p.splits > 1) {\n    const int ln",
                       "  if (false) {\n    const int ln")],
    "no_loads": [(CU, "  const int nk = max(0, min(p.per, p.k_steps - s_begin));",
                  "  const int nk = 0;")],
}
SHAPES = ("qkv", "w2", "decode_qkv_s1")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(SRC))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch

    if not torch.cuda.is_available():
        print("gemm_breakdown: needs a CUDA device", file=sys.stderr)
        return 2
    from gemm_times import VALID_SHAPES
    from kernel_timing import build_variants, card_line, time_ms
    from repro_torch.kernels import build
    from repro_torch.kernels import tiled_gemm as tg

    card = card_line()
    libs = build_variants(build, "tiled_gemm_valid", VARIANTS,
                          build.BUILD_DIR / "breakdown")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for key in SHAPES:
        m, n, k, vm, vn, vk, seg_m, seg_n = VALID_SHAPES[key]
        x = torch.randn(m, k, generator=g, device=dev).half()
        w = (torch.randn(k, n, generator=g, device=dev) / k ** 0.5).half()
        ws = [w.clone() for _ in range(max(2, int(200e6 // (w.numel() * 2)) + 1))]
        out = torch.empty(m, n, dtype=torch.half, device=dev)
        plan = tg.plan_valid_gemm(m, n, k, seg_m=seg_m, seg_n=seg_n, valid_m=vm, valid_n=vn,
                                  valid_k=vk, sm_count=build.sm_count(dev))
        part, arrivals = tg._workspace(dev, plan.workspace_floats, plan.live_tiles)
        for split in ("plan", "one_slice"):
            per, splits = ((plan.steps_per_split, plan.splits) if split == "plan"
                           else (plan.k_steps, 1))
            for name, path in libs.items():
                fn = ctypes.CDLL(str(path)).tiled_gemm_valid
                fn.restype, fn.argtypes = tg._SIGNATURES["tiled_gemm_valid"]
                it = iter(range(1 << 30))

                def run():
                    build.check(fn(1, x.data_ptr(), ws[next(it) % len(ws)].data_ptr(),
                                   out.data_ptr(), None, part.data_ptr(), arrivals.data_ptr(),
                                   m, n, k, k, n, n, seg_m, seg_n, vm, vn, vk, plan.pack,
                                   plan.m_tiles, per, splits, stream), name)
                res[f"{key}/{split}/{name}"] = round(1e3 * time_ms(run, args.iters), 2)
                arrivals.zero_()  # variants that skip the reduction leave counts behind
        del ws
    print(card)
    print(json.dumps({"us": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
