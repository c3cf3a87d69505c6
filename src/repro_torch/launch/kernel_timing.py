"""What the kernel timing scripts share: the card's name and power limit,
device times behind a sleep, the least time the card could take, the
visible pairs of causal attention, and builds of a kernel with parts cut
out.

``gemm_times.py``, ``attention_times.py``, ``scan_connective_times.py``
and the three ``*_breakdown.py`` load this module from their own
directory, not through the package, so with ``--src`` another
checkout's kernels are timed by this checkout's code; ``chip_smoke.py``
imports it from the package.  Importing it needs neither a card nor ``nvcc``.
"""
from __future__ import annotations

import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, FLOP/s of the
# bf16/fp16 tensor cores
PEAK_BYTES, PEAK_FLOPS = 3.35e12, 989e12


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
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


def bound_ms(nbytes: float, flops: float) -> float:
    """Least time (ms) of 16-bit work: max(bytes over HBM3, FLOPs over the
    tensor cores)."""
    return 1e3 * max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS)


def window_pairs(sq: int, sk: int, window: int) -> int:
    """Visible (query, key) pairs of causal window attention (``window``
    0: none), queries right-aligned to the keys."""
    return sum(min(p + 1, window) if window else p + 1 for p in range(sk - sq, sk))


def build_variants(build, name: str, variants: Dict[str, List[Tuple[str, str, str]]],
                   out_dir: Path) -> Dict[str, Path]:
    """Build ``csrc/<name>.cu`` once per variant, in parallel.

    ``variants`` maps a variant to its edits, ``(file, old, new)`` string
    replacements in the source or one of the headers it includes
    (``build.sources_of``).  Each variant's edited copies go into
    ``out_dir/<variant>/``, its library is ``lib.so`` there.  Raises if an
    edit no longer matches its file or a build fails."""
    sources = {p.name: p.read_text() for p in build.sources_of(name)}
    procs = {}
    for variant, edits in variants.items():
        texts = dict(sources)
        for f, old, new in edits:
            if old not in texts.get(f, ""):
                raise RuntimeError(f"variant {variant}: {f} changed; update the variant")
            texts[f] = texts[f].replace(old, new)
        vdir = out_dir / variant
        vdir.mkdir(parents=True, exist_ok=True)
        for f, text in texts.items():
            (vdir / f).write_text(text)
        procs[variant] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(vdir / "lib.so"),
             str(vdir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for variant, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {variant} failed to build:\n{log}")
    return {variant: out_dir / variant / "lib.so" for variant in variants}
