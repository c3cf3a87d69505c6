"""Where a dense flash-attention launch spends its time: the tensor-core
kernel built with parts cut out, each timed at the served shapes.

  python src/repro_torch/launch/attention_breakdown.py [--iters N]

Builds variants of ``kernels/csrc/flash_attention.cu`` (with its header
``flash_mma.cuh``) with ``nvcc`` into ``kernels/_build/attention_breakdown/``
and launches each through the wrapper's C interface in bf16, timing the
mean of ``--iters`` launches behind a device sleep, as
``attention_times.py`` does.  Variants (their outputs are wrong by design;
only their times mean something):

- ``full``: the kernel as it is;
- ``empty``: every block returns at once (the launch alone);
- ``no_loads``: only each q tile's first key block is loaded; later
  blocks reuse stale shared memory (no K/V traffic, no load waits);
- ``no_wait``: every load is issued, none waited for (what the loads cost
  to issue, against what waiting for them costs);
- ``no_qk``: S = Q K^T is not computed (no Q/K ldmatrix, no QK mma);
- ``no_softmax``: P is S as it comes (no max, exp, sums or rescale);
- ``no_pv``: O += P V is not computed (no V ldmatrix, no PV mma);
- ``stages3``: a three-stage K/V ring in place of two (a design
  alternative, correct output: more loads in flight, fewer blocks an SM).

Shapes: RecurrentGemma-9B's served prefill (2, 16, 2100, 256) on one KV
head, causal, window 2048; the same without a mask (every q tile sees
every key: the throughput case); StableLM-12B's chunk (1, 32, 256, 160)
over 1280 keys on 8 KV heads, causal.  Prints the card's name and power
limit, then one JSON line of milliseconds per shape and variant.  Needs a
CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[2]
_NO_SOFTMAX = [("    float mx[2] = {NEG_INF, NEG_INF};\n",
                "#if 0\n    float mx[2] = {NEG_INF, NEG_INF};\n"),
               ("    // O += P V over the", "#endif\n    // O += P V over the")]
# (file, old, new) edits of each variant
VARIANTS = {
    "full": [],
    "empty": [("flash_attention.cu", "  const int q0 = qb * MMA_BQ;\n",
               "  const int q0 = qb * MMA_BQ;\n  if (sq > 0) return;\n")],
    "no_loads": [("flash_attention.cu",
                  "    if (i + STAGES - 1 < n_kb) load_kv((i + STAGES - 1) % STAGES, "
                  "kb_lo + i + STAGES - 1);\n", "")],
    "no_wait": [("flash_attention.cu", "    cp_async_wait<STAGES - 2>();", "")],
    "no_qk": [("flash_mma.cuh", "    for (int kk = 0; kk < HDP / 16; ++kk) {\n      uint32_t a[4];",
               "    for (int kk = 0; kk < 0; ++kk) {\n      uint32_t a[4];")],
    "no_softmax": [("flash_mma.cuh", old, new) for old, new in _NO_SOFTMAX],
    "no_pv": [("flash_mma.cuh", "    // O += P V over the",
               "    return;\n    // O += P V over the")],
    "stages3": [("flash_attention.cu", "  static constexpr int STAGES = 2;",
                 "  static constexpr int STAGES = 3;")],
}
# (b, h, hkv, sq, sk, hd, causal, window)
SHAPES = {
    "recurrentgemma_prefill": (2, 16, 1, 2100, 2100, 256, True, 2048),
    "recurrentgemma_unmasked": (2, 16, 1, 2100, 2100, 256, False, 0),
    "stablelm_chunk": (1, 32, 8, 256, 1280, 160, True, 0),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(SRC))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("attention_breakdown: needs a CUDA device", file=sys.stderr)
        return 2
    from kernel_timing import build_variants, card_line, time_ms
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    card = card_line()
    libs = build_variants(build, "flash_attention", VARIANTS,
                          build.BUILD_DIR / "attention_breakdown")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for key, (b, h, hkv, sq, sk, hd, causal, window) in SHAPES.items():
        q = torch.randn(b, sq, h, hd, generator=g, device=dev).bfloat16().transpose(1, 2)
        k, v = (torch.randn(b, sk, hkv, hd, generator=g, device=dev).bfloat16()
                .transpose(1, 2) for _ in range(2))
        out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=dev).transpose(1, 2)
        path = fa.attention_path(q.dtype, hd)
        hdp = fa.head_dim_instance(hd, path)
        grid = fa.attention_grid(b, h, sq, path)
        bk = fa.attention_tiles(path, hdp)[1]
        strides = [t.stride(i) for t in (q, k, v, out) for i in (0, 2, 1)]
        for name, lib_path in libs.items():
            fn = ctypes.CDLL(str(lib_path)).flash_attention
            fn.restype, fn.argtypes = fa._DENSE_SIGNATURES["flash_attention"]

            def run():
                build.check(fn(fa._DTYPES[q.dtype], hdp, grid[0], bk, q.data_ptr(),
                               k.data_ptr(), v.data_ptr(), out.data_ptr(), None, b, h, hkv,
                               sq, sk, hd, int(causal), window, *strides, stream), name)
            res[f"{key}/{name}"] = round(time_ms(run, args.iters), 4)
    print(card)
    print(json.dumps({"ms": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
