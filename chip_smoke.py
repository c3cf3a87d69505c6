#!/usr/bin/env python3
"""Quickest proof that the PyTorch port of Galaxy runs on one NVIDIA GPU.

  python3 chip_smoke.py

Run from the root of a checkout (it imports ``src/repro_torch``), on a
host with one CUDA device and the CUDA toolkit.  Phases, each raising on
failure:

1. card    — CUDA present; the card's name and power limit; TF32 off.
2. build   — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. kernels — each hand-written kernel against its plain PyTorch version at
             the GPT2-L main-path shapes, float32 and float16, with garbage
             in every pad region (pad outputs must be exact zeros) and the
             GEMM's live-tile counter against ``dense_block_count``; times
             the kernel, the plain version and one PyTorch library call.
4. parity  — two GPT2-L-width layers in float32 through the executor:
             kernel vs eager backend logits after the prefill of 4
             prompts and after each of 8 decode steps of the 4-slot
             batch, with equal greedy tokens.
5. serve   — the Galaxy path: ``launch.serve`` with GPT2-L at full width
             and depth in float16 on the planner's uneven 3:2:2:1 plan, 8
             requests of 37-300 prompt tokens, 16 new tokens each,
             ``max_batch=4``; each of its three kernels must have launched,
             and the first served token of a request must match the eager
             backend.
6. zoo kernels — the dense flash attention and the RG-LRU scan against
             their plain versions at RecurrentGemma-9B's served prefill
             shapes: attention (2, 16, 2100, 256) on one KV head, causal,
             window 2048, float32 and bfloat16; scan (2, 2100, 4096)
             float32 with a nonzero h0.  Timed beside their plain versions,
             SDPA with the window mask (attention; the scan has no one
             PyTorch call) and their bounds.
7. zoo parity — RecurrentGemma-9B at full width cut to 5 layers (one
             rec,rec,attn group + the 2 tail rec blocks) in float32:
             kernel vs eager (plain) backend logits after a 2100-token
             prefill (longer than the window) of 2 prompts and after each
             of 8 decode steps.
8. zoo serve — the zoo path: ``launch.serve --executor zoo`` with
             RecurrentGemma-9B at full width and depth in bfloat16, 4
             requests of 300 and 2 of 2100 prompt tokens, 16 new tokens
             each, ``max_batch=4``: two waves, so exactly 24 flash and 52
             scan launches (12 attention and 26 recurrent layers per
             prefill; decode launches neither); the first served tokens of
             the 300-token wave must match the eager backend.

Where the serve time goes (``torch.profiler``) is measured apart, by
``python -m repro_torch.launch.trace_serve``.

The last two lines are the kernels' JSON record and the result.  Exits
non-zero without CUDA or without the package beside it.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, FLOP/s of the
# fp16 tensor cores and of fp32 on the CUDA cores
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float16": 989e12, "bfloat16": 989e12, "float32": 67e12}

# tolerances of kernel vs plain version (both accumulate in fp32): fp32 —
# sums of up to K=1920 products (attention: 2048 keys) taken in another
# order; fp16/bf16 — the final rounding of O(1) outputs
ATOL = {"float32": 1e-4, "float16": 1e-2, "bfloat16": 1e-2}

REPLACES = {
    "tiled_gemm_valid": "src/repro/kernels/tiled_gemm.py:162",
    "ragged_flash_attention": "src/repro/kernels/flash_attention.py:212",
    "fused_connective": "src/repro/kernels/fused_connective.py:34",
    "flash_attention": "src/repro/kernels/flash_attention.py:88",
    "rglru_scan": "src/repro/kernels/rglru_scan.py:49",
}
SOURCES = {
    "tiled_gemm_valid": "src/repro_torch/kernels/csrc/tiled_gemm_valid.cu",
    "ragged_flash_attention": "src/repro_torch/kernels/csrc/ragged_flash_attention.cu",
    "fused_connective": "src/repro_torch/kernels/csrc/fused_connective.py",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "rglru_scan": "src/repro_torch/kernels/csrc/rglru_scan.cu",
}
GALAXY_KERNELS = ("tiled_gemm_valid", "ragged_flash_attention", "fused_connective")
ZOO_KERNELS = ("flash_attention", "rglru_scan")


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 30) -> float:
    """Mean device time of ``fn`` over ``iters`` runs after warm-up.

    The runs are queued behind a device-side sleep, so the host has
    enqueued them all before the first starts: the events then time the
    device's work back to back, not the host's launch overhead."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s at the H100's clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype: str):
    """Least time (ms) the card could take, and what sets it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


class Record:
    """One kernel's line of the JSON record, summed over its shapes."""

    def __init__(self, name: str, route: str):
        self.d = {"name": name, "route": route, "source": SOURCES[name],
                  "replaces": REPLACES[name], "launches": 0, "max_abs_err": 0.0,
                  "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                  "bound_by": "bytes", "library_ms": 0.0}
        self._t_bytes = self._t_ops = 0.0

    def err(self, e: float) -> None:
        self.d["max_abs_err"] = max(self.d["max_abs_err"], e)

    def timed(self, ms, plain_ms, library_ms, nbytes, flops, dtype) -> None:
        """Add one shape's times; ``library_ms`` None: no one PyTorch call
        computes the function."""
        self.d["ms"] += ms
        self.d["plain_ms"] += plain_ms
        self.d["library_ms"] = (None if library_ms is None
                                else self.d["library_ms"] + library_ms)
        self._t_bytes += nbytes / PEAK_BYTES
        self._t_ops += flops / PEAK_FLOPS[dtype]
        self.d["bound_ms"] = 1e3 * max(self._t_bytes, self._t_ops)
        self.d["bound_by"] = "bytes" if self._t_bytes >= self._t_ops else "operations"


def check_close(name, out, ref, dtype, what):
    err = (out.float() - ref.float()).abs().max().item() if out.numel() else 0.0
    if not err <= ATOL[dtype]:
        raise AssertionError(f"{name} {what} {dtype}: max abs err {err} > {ATOL[dtype]}")
    return err


def phase_kernels(rec, plan, torch):
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        ragged_flash_attention, ragged_flash_attention_plain)
    from repro_torch.kernels.fused_connective import (
        fused_connective, fused_connective_plain)
    from repro_torch.kernels.tiled_gemm import (
        dense_block_count, tiled_gemm_valid, tiled_gemm_valid_plain)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    lay = plan.seq_layout(200)          # tiles (57, 56, 56, 31), 228 rows
    pt, hd, ph, pc = lay.pad_tile, plan.head_dim, plan.pad_heads, plan.pad_columns
    d_model = plan.d_model
    vh, vc, rows_dev = plan.heads[1], plan.columns[1], lay.tiles[1]
    # one ring step of device 1 (5 heads, 1280 columns) on a 56-row tile of
    # the 57-row padded tile, and one decode step of 4 slots
    gemms = {
        "qkv": (pt, 3 * ph * hd, d_model, rows_dev, vh * hd, d_model, pt, ph * hd),
        "wo": (pt, d_model, ph * hd, rows_dev, d_model, vh * hd, pt, d_model),
        "w1": (pt, pc, d_model, rows_dev, vc, d_model, pt, pc),
        "w2": (pt, d_model, pc, rows_dev, d_model, vc, pt, d_model),
        "decode_qkv": (4, 3 * ph * hd, d_model, 4, vh * hd, d_model, 4, ph * hd),
    }
    junk = 1e3
    for dtype in ("float32", "float16"):
        tdt = getattr(torch, dtype)
        esize = torch.finfo(tdt).bits // 8
        for key, (m, n, k, vm, vn, vk, seg_m, seg_n) in gemms.items():
            rows = (torch.arange(m, device=dev) % seg_m) < vm
            cols = (torch.arange(n, device=dev) % seg_n) < vn
            kk = torch.arange(k, device=dev) < vk
            x = torch.randn(m, k, generator=g, device=dev)
            w = torch.randn(k, n, generator=g, device=dev) / k ** 0.5
            x = torch.where(rows[:, None] & kk[None, :], x, junk).to(tdt)
            w = torch.where(kk[:, None] & cols[None, :], w, -junk).to(tdt)
            kw = dict(valid_m=vm, valid_n=vn, valid_k=vk, seg_m=seg_m, seg_n=seg_n)
            out, cnt = tiled_gemm_valid(x, w, count_blocks=True, **kw)
            plain = tiled_gemm_valid_plain(x, w, **kw)
            torch.cuda.synchronize()
            err = check_close("tiled_gemm_valid", out, plain, dtype, key)
            if out[~rows].any() or out[:, ~cols].any():
                raise AssertionError(f"tiled_gemm_valid {key} {dtype}: pad outputs not zero")
            want = dense_block_count(m, n, k, **kw)
            if int(cnt) != want:
                raise AssertionError(f"tiled_gemm_valid {key}: live tiles {int(cnt)} != {want}")
            log("kernels", f"tiled_gemm_valid {key} {dtype} ({m}x{k})@({k}x{n}) "
                f"valid=({vm},{vn},{vk}) err={err:.3g} live_tiles={want}")
            if dtype != "float16":
                continue
            rec["tiled_gemm_valid"].err(err)
            if key == "decode_qkv":
                continue
            # cycle weight copies past the 50 MB L2: the served model's
            # weights (2.2 GB) are cold when each GEMM reads them
            copies = max(2, int(200e6 // (w.numel() * esize)) + 1)
            ws = [w.clone() for _ in range(copies)]
            xm = torch.where(rows[:, None] & kk[None, :], x, 0)
            wm = [torch.where(kk[:, None] & cols[None, :], c, 0) for c in ws]
            it = iter(range(1 << 30))

            def nxt(lst):
                return lst[next(it) % len(lst)]

            ms = time_ms(lambda: tiled_gemm_valid(x, nxt(ws), **kw))
            plain_ms = time_ms(lambda: tiled_gemm_valid_plain(x, nxt(ws), **kw))
            lib_ms = time_ms(lambda: torch.matmul(xm, nxt(wm)))
            live_m = (m // seg_m) * vm
            live_n = (n // seg_n) * vn
            nbytes = esize * (live_m * vk + vk * live_n + m * n)
            flops = 2.0 * live_m * live_n * vk
            rec["tiled_gemm_valid"].timed(ms, plain_ms, lib_ms, nbytes, flops, dtype)
            bms, by = bound(nbytes, flops, dtype)
            log("kernels", f"tiled_gemm_valid {key} fp16: {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")

        # ragged attention on device 1's shard: (1, 8, 228, 64) views of
        # the fused QKV output, 5 valid heads
        s = lay.padded_len
        pos = lay.positions
        pad = torch.as_tensor(~lay.valid, device=dev)
        qkv = torch.randn(1, s, 3 * ph, hd, generator=g, device=dev)
        qkv[:, pad] = junk
        qkv[:, :, vh:ph] = -junk
        qkv = qkv.to(tdt)
        q, k, v = (t.transpose(1, 2) for t in qkv.split(ph, dim=2))
        out = ragged_flash_attention(q, k, v, positions=pos, valid_heads=vh)
        plain = ragged_flash_attention_plain(q, k, v, positions=pos, valid_heads=vh)
        torch.cuda.synchronize()
        err = check_close("ragged_flash_attention", out, plain, dtype, "shard")
        if out[:, :, pad].any() or out[:, vh:].any():
            raise AssertionError(f"ragged_flash_attention {dtype}: pad rows/heads not zero")
        log("kernels", f"ragged_flash_attention {dtype} (1,{ph},{s},{hd}) "
            f"valid_heads={vh} err={err:.3g}")
        if dtype == "float16":
            rec["ragged_flash_attention"].err(err)
            mask = torch.as_tensor(lay.attention_mask(), device=dev)
            qc, kc, vc_ = (t.contiguous() for t in (q, k, v))
            ms = time_ms(lambda: ragged_flash_attention(q, k, v, positions=pos,
                                                        valid_heads=vh))
            plain_ms = time_ms(lambda: ragged_flash_attention_plain(
                q, k, v, positions=pos, valid_heads=vh))
            lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qc, kc, vc_, attn_mask=mask))
            n_valid = lay.seq
            pairs = n_valid * (n_valid + 1) // 2      # visible (query, key) pairs
            flops = 4.0 * pairs * vh * hd
            nbytes = esize * (3 * n_valid * vh * hd + s * ph * hd)
            rec["ragged_flash_attention"].timed(ms, plain_ms, lib_ms, nbytes, flops, dtype)
            bms, by = bound(nbytes, flops, dtype)
            log("kernels", f"ragged_flash_attention fp16: {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")

        # connective on a 57-row tile, rate 0 (the path) and 0.1 (dropout)
        for rate in (0.0, 0.1):
            x, res = (torch.randn(pt, d_model, generator=g, device=dev).to(tdt)
                      for _ in range(2))
            keep = (torch.rand(pt, d_model, generator=g, device=dev) > rate).to(tdt)
            scale = (1 + 0.1 * torch.randn(d_model, generator=g, device=dev)).to(tdt)
            bias = (0.1 * torch.randn(d_model, generator=g, device=dev)).to(tdt)
            out = fused_connective(x, res, keep, scale, bias, rate=rate)
            plain = fused_connective_plain(x, res, keep, scale, bias, rate=rate)
            torch.cuda.synchronize()
            err = check_close("fused_connective", out, plain, dtype, f"rate={rate}")
            log("kernels", f"fused_connective {dtype} ({pt},{d_model}) rate={rate} err={err:.3g}")
            if dtype == "float16" and rate == 0.0:
                rec["fused_connective"].err(err)
                ms = time_ms(lambda: ops.connective(x, res, scale, bias))
                plain_ms = time_ms(lambda: fused_connective_plain(x, res, None, scale, bias))
                lib_ms = time_ms(lambda: torch.nn.functional.layer_norm(
                    x + res, (d_model,), scale, bias, 1e-5))
                nbytes = esize * (3 * pt * d_model + 2 * d_model)
                flops = 8.0 * pt * d_model
                rec["fused_connective"].timed(ms, plain_ms, lib_ms, nbytes, flops, dtype)
                bms, by = bound(nbytes, flops, dtype)
                log("kernels", f"fused_connective fp16: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"layer_norm(x+res) {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")


def phase_parity(cfg, plan, torch):
    """Two GPT2-L-width layers in fp32: kernel vs eager backend, prefill of
    4 prompts and 8 decode steps of the 4-slot batch, logits compared at
    every step and greedy tokens fed back."""
    from repro_torch.launch.serve import build_executor

    dev = torch.device("cuda")
    kern = build_executor(cfg, plan.with_backend("kernel"), device=dev,
                          dtype=torch.float32, seed=1, num_layers=2)
    eager = copy.copy(kern)  # the same weight shards, the oracle backend
    eager.plan = kern.plan.with_backend("eager")
    lens, page, width, steps = (91, 37, 64, 50), 16, 7, 8
    prompts = torch.randint(0, cfg.vocab_size, (len(lens), 96), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(2))
    block_table = 1 + torch.arange(len(lens) * width, device=dev).view(len(lens), width)
    pools, logits = {}, {}
    for name, ex in (("kernel", kern), ("eager", eager)):
        pools[name] = ex.make_pool(1 + len(lens) * width, page)
        rows = []
        for b, n in enumerate(lens):
            n_pad = -(-n // page) * page
            out, _ = ex.prefill_paged(prompts[b:b + 1, :n_pad], pools[name],
                                      block_table[b], length=n)
            rows.append(out)
        logits[name] = torch.cat(rows)
    # fp32 through two layers: GEMM sums of K <= 1920 taken in another order
    tol = 1e-4
    err = (logits["kernel"] - logits["eager"]).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"prefill logits kernel vs eager: max abs err {err} > {tol}")
    positions = torch.tensor(lens, device=dev)
    derr, tokens = 0.0, []
    for step in range(steps):
        tok = logits["kernel"].argmax(-1)
        if not torch.equal(tok, logits["eager"].argmax(-1)):
            raise AssertionError(f"decode step {step}: greedy tokens differ")
        tokens.append(tok.tolist())
        for name, ex in (("kernel", kern), ("eager", eager)):
            logits[name], _ = ex.decode_paged(tok[:, None], pools[name], block_table,
                                              positions + step)
        e = (logits["kernel"] - logits["eager"]).abs().max().item()
        if not e <= tol:
            raise AssertionError(f"decode step {step} logits kernel vs eager: "
                                 f"max abs err {e} > {tol}")
        derr = max(derr, e)
    log("parity", f"2 layers fp32, {len(lens)} slots: prefill logits max abs err "
        f"{err:.3g}; {steps} decode steps logits max abs err {derr:.3g}, greedy "
        f"tokens equal: {tokens}")


def phase_serve(torch, rec):
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    n_req, max_new = 8, 16
    ops.reset_launch_counts()
    out = launch_serve.serve("gpt2-l", (3, 2, 2, 1), requests=n_req,
                             prompt_len=(37, 300), max_new=max_new, max_batch=4,
                             device="cuda", dtype="float16", seed=0)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    reqs = out["requests"]
    log("serve", out["plan"])
    if len(reqs) != n_req or any(len(r.output) != max_new for r in reqs):
        raise AssertionError(f"unfinished requests: {[len(r.output) for r in reqs]}")
    steps = out["stats"]["decode_steps"]
    expect = {"tiled_gemm_valid": n_req * 2304 + steps * 576,
              "ragged_flash_attention": n_req * 144,
              "fused_connective": n_req * 288}
    for name in GALAXY_KERNELS:
        n = counts[name]
        if n <= 0:
            raise AssertionError(f"{name} never launched on the Galaxy path")
        rec[name].d["launches"] = n
        note = "as expected" if n == expect[name] else f"expected {expect[name]}"
        log("serve", f"{name}: {n} launches ({note})")
    for name in ZOO_KERNELS:
        if counts[name]:
            raise AssertionError(f"{name} launched {counts[name]} times on the Galaxy path")
    log("serve", f"{n_req} requests, prompts {[len(r.prompt) for r in reqs]}, "
        f"{out['new_tokens']} new tokens in {out['seconds']:.2f} s: "
        f"{out['tokens_per_s']:.1f} tok/s, TTFT p50 {1e3 * out['ttft_p50_s']:.1f} ms, "
        f"{steps} decode steps, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return out


def check_served_token(out, torch):
    """Request 0's prefill logits from the kernel backend agree with the
    eager backend on the same fp16 weights at full depth, the first served
    token is the kernel backend's argmax, and it is the eager backend's
    argmax up to the fp16 disagreement (a near-tie may flip the order)."""
    import numpy as np

    kern = out["executor"]
    eager = copy.copy(kern)
    eager.plan = kern.plan.with_backend("eager")
    req = out["requests"][0]
    s = len(req.prompt)
    s_pad = -(-s // 16) * 16
    toks = np.zeros((1, s_pad), np.int64)
    toks[0, :s] = req.prompt
    logits = {}
    for name, ex in (("kernel", kern), ("eager", eager)):
        pool = ex.make_pool(1 + s_pad // 16, 16)
        logits[name], _ = ex.prefill_paged(toks, pool, list(range(1, 1 + s_pad // 16)),
                                           length=s)
    # fp16 through 36 layers: the eager path rounds attention scores and
    # probabilities to fp16 where the kernel keeps them in fp32
    tol = 5e-2
    kl, el = logits["kernel"].float()[0], logits["eager"].float()[0]
    err = (kl - el).abs().max().item()
    first = int(kl.argmax())
    gap = (el.max() - el[first]).item()
    if not np.isfinite(err) or err > tol or first != req.output[0] or gap > tol:
        raise AssertionError(f"served token check: err {err}, served {req.output[0]}, "
                             f"kernel argmax {first}, eager argmax {int(el.argmax())} "
                             f"(gap {gap})")
    log("serve", f"request 0 ({s} tokens, 36 layers fp16): kernel vs eager prefill "
        f"logits max abs err {err:.3g}; first token {first} == served")


def window_pairs(sq: int, sk: int, window: int) -> int:
    """Visible (query, key) pairs of causal window attention, queries
    right-aligned to the keys."""
    return sum(min(p + 1, window) if window else p + 1 for p in range(sk - sq, sk))


def phase_zoo_kernels(rec, torch):
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    b, h, hkv, s, hd, window = 2, 16, 1, 2100, 256, 2048
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        # transposed views of the zoo's (B, S, H, hd) projections
        q = torch.randn(b, s, h, hd, generator=g, device=dev).to(tdt).transpose(1, 2)
        k, v = (torch.randn(b, s, hkv, hd, generator=g, device=dev).to(tdt).transpose(1, 2)
                for _ in range(2))
        out = flash_attention(q, k, v, causal=True, window=window)
        plain = flash_attention_plain(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        err = check_close("flash_attention", out, plain, dtype, "served prefill")
        log("kernels", f"flash_attention {dtype} q ({b},{h},{s},{hd}) kv ({b},{hkv},{s},{hd}) "
            f"causal window={window} err={err:.3g}")
        if dtype != "bfloat16":
            continue
        rec["flash_attention"].err(err)
        pos = torch.arange(s, device=dev)
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        ms = time_ms(lambda: flash_attention(q, k, v, causal=True, window=window), iters=10)
        plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, causal=True, window=window),
                           iters=5)
        lib_ms = time_ms(lambda: sdpa(qc, kc, vc, attn_mask=mask, enable_gqa=True), iters=10)
        esize = 2
        nbytes = esize * (2 * b * h * s * hd + 2 * b * hkv * s * hd)
        flops = 4.0 * window_pairs(s, s, window) * hd * h * b
        rec["flash_attention"].timed(ms, plain_ms, lib_ms, nbytes, flops, dtype)
        bms, by = bound(nbytes, flops, dtype)
        log("kernels", f"flash_attention bf16: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")

    w = 4096
    a = 0.5 + 0.499 * torch.rand(b, s, w, generator=g, device=dev)
    bb = torch.randn(b, s, w, generator=g, device=dev)
    h0 = torch.randn(b, w, generator=g, device=dev)
    hs, hl = rglru_scan(a, bb, h0)
    ps, pl = rglru_scan_plain(a, bb, h0)
    torch.cuda.synchronize()
    err = max(check_close("rglru_scan", hs, ps, "float32", "h_seq"),
              check_close("rglru_scan", hl, pl, "float32", "h_last"))
    rec["rglru_scan"].err(err)
    log("kernels", f"rglru_scan float32 ({b},{s},{w}) nonzero h0: h_seq and h_last err={err:.3g}")
    ms = time_ms(lambda: rglru_scan(a, bb, h0))
    plain_ms = time_ms(lambda: rglru_scan_plain(a, bb, h0), iters=3)
    nbytes = 4 * (3 * b * s * w + 2 * b * w)
    flops = 2.0 * b * s * w
    rec["rglru_scan"].timed(ms, plain_ms, None, nbytes, flops, "float32")
    bms, by = bound(nbytes, flops, "float32")
    log("kernels", f"rglru_scan fp32: {ms:.4f} ms, plain {plain_ms:.4f} ms, no library call, "
        f"bound {bms:.4f} ms ({by})")


def phase_zoo_parity(torch):
    """RecurrentGemma-9B at full width, 5 layers, fp32: kernel vs eager
    backend logits after a 2100-token prefill and 8 decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import TransformerExecutor

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), num_layers=5,
                              dtype="float32", param_dtype="float32")
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(5),
                         device=dev)
    kern = TransformerExecutor(params, cfg, backend="kernel")
    eager = TransformerExecutor(params, cfg, backend="eager")
    b, s, steps = 2, 2100, 8
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(6))
    ops.reset_launch_counts()
    lk, ck = kern.prefill(tokens, kern.make_cache(b, s + steps))
    counts = ops.launch_counts()
    if (counts["flash_attention"], counts["rglru_scan"]) != (1, 4):
        raise AssertionError(f"5-layer prefill launches: {counts}")
    le, ce = eager.prefill(tokens, eager.make_cache(b, s + steps))
    # fp32 through 5 full-width layers: the paths differ only in the
    # attention's and the scan's summation order
    tol = 1e-4
    err = (lk - le).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"zoo prefill logits kernel vs eager: max abs err {err} > {tol}")
    derr, toks = 0.0, []
    for step in range(steps):
        tok = le.argmax(-1)
        if not torch.equal(tok, lk.argmax(-1)):
            raise AssertionError(f"zoo decode step {step}: greedy tokens differ")
        toks.append(tok.tolist())
        lk, ck = kern.decode(tok[:, None], ck, s + step)
        le, ce = eager.decode(tok[:, None], ce, s + step)
        e = (lk - le).abs().max().item()
        if not e <= tol:
            raise AssertionError(f"zoo decode step {step} logits kernel vs eager: "
                                 f"max abs err {e} > {tol}")
        derr = max(derr, e)
    if ops.launch_counts() != counts:
        raise AssertionError("a zoo decode step launched a prefill kernel")
    log("parity", f"RecurrentGemma-9B width, 5 layers fp32, {b} x {s}-token prefill "
        f"(window {cfg.window}): logits max abs err {err:.3g}; {steps} decode steps "
        f"max abs err {derr:.3g} (tolerance {tol}); greedy tokens equal: {toks}")


def phase_zoo_serve(torch, rec):
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve

    torch.cuda.reset_peak_memory_stats()
    lens, max_new = [300] * 4 + [2100] * 2, 16
    ops.reset_launch_counts()
    out = launch_serve.serve("recurrentgemma-9b", executor_kind="zoo", prompt_lens=lens,
                             max_new=max_new, max_batch=4, device="cuda",
                             dtype="bfloat16", seed=0)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    reqs = out["requests"]
    log("serve", out["plan"])
    if len(reqs) != len(lens) or any(len(r.output) != max_new for r in reqs):
        raise AssertionError(f"unfinished zoo requests: {[len(r.output) for r in reqs]}")
    cfg = out["executor"].cfg
    waves = 2
    expect = {name: 0 for name in counts}
    expect["flash_attention"] = cfg.layer_kinds().count("attn") * waves
    expect["rglru_scan"] = cfg.layer_kinds().count("rec") * waves
    for name in ZOO_KERNELS:
        rec[name].d["launches"] = counts[name]
        log("serve", f"{name}: {counts[name]} launches (expected {expect[name]})")
    if counts != expect:
        raise AssertionError(f"zoo launch counts {counts} != {expect}")
    steps = out["stats"]["decode_steps"]
    log("serve", f"{len(reqs)} requests, prompts {[len(r.prompt) for r in reqs]}, "
        f"{out['new_tokens']} new tokens in {out['seconds']:.2f} s: "
        f"{out['tokens_per_s']:.1f} tok/s, TTFT p50 {1e3 * out['ttft_p50_s']:.1f} ms, "
        f"{steps} decode steps, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return out


def check_zoo_served_tokens(out, torch):
    """The 300-token wave again, kernel vs eager backend at full depth in
    bf16: the kernel prefill reproduces the served first tokens, and each
    is the eager backend's argmax up to the bf16 disagreement."""
    import numpy as np

    from repro_torch.serving.engine import TransformerExecutor

    kern = out["executor"]
    eager = TransformerExecutor(kern.params, kern.cfg, backend="eager")
    reqs = [r for r in out["requests"] if len(r.prompt) == 300]
    tokens = np.array([r.prompt for r in reqs])
    served = torch.tensor([r.output[0] for r in reqs], device=kern.device)
    lk, _ = kern.prefill(tokens, kern.make_cache(len(reqs), 316))
    le, _ = eager.prefill(tokens, eager.make_cache(len(reqs), 316))
    # bf16 through 38 layers: the attention's fp32 sums in another order
    # flip the last bf16 bit of some outputs, and that propagates
    tol = 1e-1
    lk, le = lk.float(), le.float()
    err = (lk - le).abs().max().item()
    first = lk.argmax(-1)
    gap = (le.max(-1).values - le.gather(1, first[:, None])[:, 0]).max().item()
    if not np.isfinite(err) or err > tol or not torch.equal(first, served) or gap > tol:
        raise AssertionError(f"zoo served token check: err {err}, served {served.tolist()}, "
                             f"kernel argmax {first.tolist()}, eager argmax "
                             f"{le.argmax(-1).tolist()} (gap {gap})")
    log("serve", f"{len(reqs)} x 300 tokens, 38 layers bf16: kernel vs eager prefill logits "
        f"max abs err {err:.3g}; first tokens {first.tolist()} == served")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no repro_torch package under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()

    card = card_line()
    log("card", f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.serve import build_plan

    t0 = time.perf_counter()
    secs = build.build_all()
    log("build", f"{len(secs)} CUDA sources built in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())})")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"{name}: {line.strip()}")

    cfg = get_config("gpt2-l")
    plan = build_plan(cfg, (3, 2, 2, 1))
    rec = {"tiled_gemm_valid": Record("tiled_gemm_valid", "cuda"),
           "ragged_flash_attention": Record("ragged_flash_attention", "cuda"),
           "fused_connective": Record("fused_connective", "triton"),
           "flash_attention": Record("flash_attention", "cuda"),
           "rglru_scan": Record("rglru_scan", "cuda")}
    phase_kernels(rec, plan, torch)
    phase_parity(cfg, plan, torch)
    out = phase_serve(torch, rec)
    check_served_token(out, torch)
    del out
    torch.cuda.empty_cache()

    phase_zoo_kernels(rec, torch)
    torch.cuda.empty_cache()
    phase_zoo_parity(torch)
    torch.cuda.empty_cache()
    out = phase_zoo_serve(torch, rec)
    check_zoo_served_tokens(out, torch)

    log("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": [r.d for r in rec.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
