"""Device times of the two attention kernels at the shapes the serving paths
give them, for one checkout of the port.

  python src/repro_torch/launch/attention_times.py [--src DIR] [--iters N]

Imports ``repro_torch`` from ``--src`` (default: the ``src`` directory of
the checkout this file is in) and touches only the kernels' public
wrappers, so one run of this file can time an older checkout's kernels
beside this one's on the same card: run it once per checkout, in turns
(older, newer, newer, older).  Shapes, in the dtype each path serves:

- ``recurrentgemma_prefill``: RecurrentGemma-9B's served prefill, q (2,
  16, 2100, 256) on one KV head, causal, window 2048, bf16;
- ``stablelm_chunk``: StableLM-12B's 256-token prefill chunk at offset
  1024, q (1, 32, 256, 160) over 1280 keys on 8 KV heads, strided views of
  the gathered page view, causal, bf16;
- ``galaxy_shard``: device 1's ragged shard of the GPT2-L 3:2:2:1 plan,
  (1, 8, 228, 64) views of the fused QKV output, 5 valid heads, fp16.

Each time is the mean over ``--iters`` launches queued behind a device
sleep; beside it, one ``scaled_dot_product_attention`` call on the same
inputs (contiguous copies, the mask as a boolean tensor) and the bound,
max(bytes / 3.35 TB/s, FLOPs / 989 TFLOP/s) from the visible (query,
key) pairs.  Prints the card's name and power limit, then one JSON object.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch

    if not torch.cuda.is_available():
        print("attention_times: needs a CUDA device", file=sys.stderr)
        return 2
    from kernel_timing import bound_ms, card_line, time_ms, window_pairs
    from repro_torch.core.execplan import SeqLayout
    from repro_torch.kernels.flash_attention import flash_attention, ragged_flash_attention

    card = card_line()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    res = {}

    # dense: (b, h, hkv, sq, sk, hd, window, view rows)
    dense = {"recurrentgemma_prefill": (2, 16, 1, 2100, 2100, 256, 2048, 2100),
             "stablelm_chunk": (1, 32, 8, 256, 1280, 160, 0, 97 * 16)}
    for key, (b, h, hkv, sq, sk, hd, window, view) in dense.items():
        q = torch.randn(b, sq, h, hd, generator=g, device=dev).bfloat16().transpose(1, 2)
        kc, vc = (torch.randn(b, view, hkv, hd, generator=g, device=dev).bfloat16()
                  for _ in range(2))
        k, v = kc[:, :sk].transpose(1, 2), vc[:, :sk].transpose(1, 2)
        qp = torch.arange(sk - sq, sk, device=dev)[:, None]
        kp = torch.arange(sk, device=dev)[None, :]
        mask = (kp <= qp) & ((kp > qp - window) if window else True)
        qq, kk, vv = (t.contiguous() for t in (q, k, v))
        ms = time_ms(lambda: flash_attention(q, k, v, causal=True, window=window),
                     args.iters)
        lib = time_ms(lambda: sdpa(qq, kk, vv, attn_mask=mask, enable_gqa=True),
                      args.iters)
        nbytes = 2 * (2 * b * h * sq * hd + 2 * b * hkv * sk * hd)
        flops = 4.0 * window_pairs(sq, sk, window) * hd * h * b
        res[key] = {"ms": ms, "sdpa_ms": lib, "bound_ms": bound_ms(nbytes, flops)}
        del q, k, v, kc, vc, qq, kk, vv

    # ragged: device 1's shard of the 3:2:2:1 plan at a 200-token prompt
    lay = SeqLayout((57, 56, 56, 31))
    s, ph, vh, hd = lay.padded_len, 8, 5, 64
    qkv = torch.randn(1, s, 3 * ph, hd, generator=g, device=dev).half()
    q, k, v = (t.transpose(1, 2) for t in qkv.split(ph, dim=2))
    mask = torch.as_tensor(lay.attention_mask(), device=dev)
    qq, kk, vv = (t.contiguous() for t in (q, k, v))
    ms = time_ms(lambda: ragged_flash_attention(q, k, v, positions=lay.positions,
                                                valid_heads=vh), args.iters)
    lib = time_ms(lambda: sdpa(qq, kk, vv, attn_mask=mask), args.iters)
    n = lay.seq
    nbytes = 2 * (3 * n * vh * hd + s * ph * hd)
    flops = 4.0 * (n * (n + 1) // 2) * vh * hd
    res["galaxy_shard"] = {"ms": ms, "sdpa_ms": lib, "bound_ms": bound_ms(nbytes, flops)}

    print(card)
    print(json.dumps({"src": args.src, "ms": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
