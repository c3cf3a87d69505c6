"""Device times of the two GEMM kernels at the shapes the serving paths
give them, for one checkout of the port.

  python src/repro_torch/launch/gemm_times.py [--src DIR] [--iters N]

Imports ``repro_torch`` from ``--src`` (default: the ``src`` directory of
the checkout this file is in) and touches only the kernels' public
wrappers, so one run of this file can time an older checkout's kernels
beside this one's on the same card: run it once per checkout, in turns
(older, newer, newer, older).  Shapes: device 1's GEMMs of the GPT2-L
3:2:2:1 plan, fp16, on a 57-row ring tile (QKV, WO, W1, W2) and in a
4-slot decode step as the executor launches it, ``(4, 1, d)`` folded to
one-row segments (QKV, W2); and StableLM-12B's MLP up-projection on a
512-row chunk, ``(512 x 5120) @ (5120 x 13824)`` bf16, for the dense
kernel.  The valid-length GEMM reads cold weights (copies cycled past
the 50 MB L2), as the served model's 2.2 GB of weights are; each time is
the mean over ``--iters`` launches queued behind a device sleep.  Prints
the card's name and power limit, then one JSON object of milliseconds.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

# (m, n, k, valid_m, valid_n, valid_k, seg_m, seg_n)
VALID_SHAPES = {
    "qkv": (57, 1536, 1280, 56, 320, 1280, 57, 512),
    "wo": (57, 1280, 512, 56, 1280, 320, 57, 1280),
    "w1": (57, 1920, 1280, 56, 1280, 1280, 57, 1920),
    "w2": (57, 1280, 1920, 56, 1280, 1280, 57, 1280),
    "decode_qkv_s1": (4, 1536, 1280, 1, 320, 1280, 1, 512),
    "decode_w2_s1": (4, 1280, 1920, 1, 1280, 1280, 1, 1280),
}
DENSE_SHAPE = (512, 5120, 13824)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch

    if not torch.cuda.is_available():
        print("gemm_times: needs a CUDA device", file=sys.stderr)
        return 2
    from kernel_timing import card_line, time_ms
    from repro_torch.kernels.tiled_gemm import tiled_gemm, tiled_gemm_valid

    card = card_line()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    res = {}
    for key, (m, n, k, vm, vn, vk, seg_m, seg_n) in VALID_SHAPES.items():
        x = torch.randn(m, k, generator=g, device=dev).half()
        w = (torch.randn(k, n, generator=g, device=dev) / k ** 0.5).half()
        copies = max(2, int(200e6 // (w.numel() * 2)) + 1)
        ws = [w.clone() for _ in range(copies)]
        it = iter(range(1 << 30))
        kw = dict(valid_m=vm, valid_n=vn, valid_k=vk, seg_m=seg_m, seg_n=seg_n)
        res[key] = time_ms(lambda: tiled_gemm_valid(
            x, ws[next(it) % copies], **kw), args.iters)
        del ws
    m, k, n = DENSE_SHAPE
    x = torch.randn(m, k, generator=g, device=dev).bfloat16()
    w = (torch.randn(k, n, generator=g, device=dev) / k ** 0.5).bfloat16()
    res["dense_512x5120x13824"] = time_ms(lambda: tiled_gemm(x, w), 10)
    print(card)
    print(json.dumps({"src": args.src, "ms": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
