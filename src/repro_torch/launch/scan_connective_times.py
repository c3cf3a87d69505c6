"""Device times of the RG-LRU scan and the fused connective at the shapes
the serving paths give them, for one checkout of the port.

  python src/repro_torch/launch/scan_connective_times.py [--src DIR] [--iters N]

Imports ``repro_torch`` from ``--src`` (default: the ``src`` directory of
the checkout this file is in) and touches only the kernels' public
wrappers, so one run of this file can time an older checkout's kernels
beside this one's on the same card: run it once per checkout, in turns
(older, newer, newer, older).  Shapes:

- ``scan_wave1`` / ``scan_wave2``: RecurrentGemma-9B's two served prefill
  waves, (4, 300, 4096) and (2, 2100, 4096) float32 (the gates' dtype),
  nonzero h0;
- ``connective_site``: one Galaxy connective site of GPT2-L on the
  3:2:2:1 plan, four shards of 57 x 1280 fp16 (the padded tiles), each
  with its own scale and bias, as ``ops.connective_group`` computes it
  (a checkout without it: ``ops.connective`` shard by shard, as its layer
  did), with the launches the site took;
- ``connective_shard``: one of those shards alone through
  ``ops.connective``.

Each time is the mean over ``--iters`` calls queued behind a device
sleep; beside it the plain version's, the bound (bytes / 3.35 TB/s: each
input read once, each output written once) and, for the connective,
``layer_norm(x + res)`` over the site's rows stacked into one tensor (the
scan has no one PyTorch call), and ``host_us``: the host's wall time per
call of a loop of calls that are not waited for, which is what launching
the call costs the host (its device work takes less).  Prints the card's
name and power limit, then one JSON object.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def host_us(fn, iters: int) -> float:
    """Host wall time (us) per call of ``fn`` over ``iters`` calls made
    back to back, after a warm-up; the device is waited for only after
    the clock stops."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch

    if not torch.cuda.is_available():
        print("scan_connective_times: needs a CUDA device", file=sys.stderr)
        return 2
    from kernel_timing import PEAK_BYTES, card_line, time_ms
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_connective import fused_connective_plain
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_plain

    card = card_line()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    res = {}

    for key, (b, s, w) in {"scan_wave1": (4, 300, 4096),
                           "scan_wave2": (2, 2100, 4096)}.items():
        a = 0.5 + 0.499 * torch.rand(b, s, w, generator=g, device=dev)
        bb = torch.randn(b, s, w, generator=g, device=dev)
        h0 = torch.randn(b, w, generator=g, device=dev)
        ms = time_ms(lambda: rglru_scan(a, bb, h0), args.iters)
        plain = time_ms(lambda: rglru_scan_plain(a, bb, h0), 3)
        nbytes = 4 * (3 * b * s * w + 2 * b * w)
        res[key] = {"ms": ms, "plain_ms": plain, "bound_ms": 1e3 * nbytes / PEAK_BYTES}
        del a, bb

    rows, d = (57, 57, 57, 57), 1280
    xs, rs = ([torch.randn(r, d, generator=g, device=dev).half() for r in rows]
              for _ in range(2))
    scales = [(1 + 0.1 * torch.randn(d, generator=g, device=dev)).half() for _ in rows]
    biases = [(0.1 * torch.randn(d, generator=g, device=dev)).half() for _ in rows]
    group = getattr(ops, "connective_group", None)
    if group is None:  # before the grouped launch: one launch a shard
        def group(xs, rs, scales, biases):
            return [ops.connective(*t) for t in zip(xs, rs, scales, biases)]
    ops.reset_launch_counts()
    group(xs, rs, scales, biases)
    torch.cuda.synchronize()
    launches = ops.launch_counts()["fused_connective"]
    xcat, rcat = torch.cat(xs), torch.cat(rs)
    ln = torch.nn.functional.layer_norm
    n = sum(rows)
    res["connective_site"] = {
        "ms": time_ms(lambda: group(xs, rs, scales, biases), args.iters),
        "host_us": host_us(lambda: group(xs, rs, scales, biases), 10 * args.iters),
        "launches": launches,
        "plain_ms": time_ms(lambda: [fused_connective_plain(x, r, None, sc, bi)
                                     for x, r, sc, bi in zip(xs, rs, scales, biases)],
                            args.iters),
        "layer_norm_ms": time_ms(lambda: ln(xcat + rcat, (d,), scales[0], biases[0], 1e-5),
                                 args.iters),
        "bound_ms": 1e3 * 2 * (3 * n * d + 2 * len(rows) * d) / PEAK_BYTES,
    }
    x, r, sc, bi = xs[0], rs[0], scales[0], biases[0]
    res["connective_shard"] = {
        "ms": time_ms(lambda: ops.connective(x, r, sc, bi), args.iters),
        "host_us": host_us(lambda: ops.connective(x, r, sc, bi), 10 * args.iters),
        "plain_ms": time_ms(lambda: fused_connective_plain(x, r, None, sc, bi), args.iters),
        "layer_norm_ms": time_ms(lambda: ln(x + r, (d,), sc, bi, 1e-5), args.iters),
        "bound_ms": 1e3 * 2 * (3 * rows[0] * d + 2 * d) / PEAK_BYTES,
    }

    print(card)
    print(json.dumps({"src": args.src, "ms": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
