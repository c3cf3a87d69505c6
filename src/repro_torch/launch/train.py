"""End-to-end training entry point (counterpart of ``src/repro/launch/train.py``).

Trains one of the reference's assigned architectures on the data
pipeline's synthetic stream (or ``--text``), with AdamW on a cosine
schedule, and prints the reference's log lines (loss, grad norm, lr,
tokens/s) and, on CUDA, the peak device memory.  Weights are random,
drawn on the device from a fixed seed.  For example, on the CPU:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --reduce --device cpu --steps 20

and at full size on one GPU:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --steps 20 --batch 8 --seq 128

Runs on ``cuda`` unless ``--device cpu`` is given, and refuses to start
when CUDA is absent and the CPU was not asked for.  ``--backend kernel``
(the default) runs the flash attention and RG-LRU scan kernels, with
their gradients, ``eager`` their plain versions.  An architecture whose
parameters, gradients and fp32 Adam moments do not fit one card is
refused at full size (``--reduce`` trains its small variant).  Every
step waits for the device, so the step times are whole steps.
Step ``n`` draws its dropout masks (a config with ``dropout_rate > 0``)
from seed ``n``, as the reference's step takes ``jax.random.PRNGKey(n)``.
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ASSIGNED_ARCHS, ModelConfig, get_config, reduced
from repro_torch.data import DataConfig, LMDataPipeline
from repro_torch.launch.serve import CARD_BYTES
from repro_torch.models.params import init_params, param_bytes
from repro_torch.training import AdamW, cosine_schedule, make_train_step, save_checkpoint
from repro_torch.training.train_loop import batch_to_device


def train_bytes(cfg: ModelConfig) -> int:
    """Bytes a train step holds besides activations: the parameter tree
    (padded vocabulary and experts included) and its gradients in
    ``param_dtype``, and the two fp32 Adam moments."""
    pb = param_bytes(cfg)
    n = pb // getattr(torch, cfg.param_dtype).itemsize
    return 2 * pb + 8 * n


def check_fits_one_card(cfg: ModelConfig) -> None:
    need = train_bytes(cfg)
    if need > CARD_BYTES:
        raise ValueError(
            f"{cfg.name} needs {need / 1e9:.1f} GB for its parameters, gradients and "
            f"fp32 Adam moments, more than one card's {CARD_BYTES / 1e9:.0f} GB: "
            "train its small variant with --reduce")


def train(cfg: ModelConfig, *, steps: int = 200, batch: int = 8, seq: int = 128,
          lr: float = 1e-3, warmup: int = 20, ckpt: Optional[str] = None,
          ckpt_every: int = 100, log_every: int = 10, text: Optional[str] = None,
          device=None, backend: str = "kernel", params: Optional[Dict] = None,
          log: Callable[[str], None] = print) -> Dict:
    """Train ``cfg`` for ``steps`` steps and return the per-step losses,
    grad norms and wall times (s), tokens/s over the run, the peak device
    memory (bytes, CUDA only), the final params and optimizer state.
    ``params`` starts from given weights (updated in place) instead of
    drawing them from seed 0."""
    dev = resolve_device(device)
    if params is None:
        params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    opt = AdamW(cosine_schedule(lr, warmup, steps))
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt, backend=backend)
    pipe = iter(LMDataPipeline(cfg, DataConfig(batch_size=batch, seq_len=seq,
                                               text_path=text)))
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    losses, gnorms, step_s = [], [], []
    t0 = time.perf_counter()
    tokens_seen = 0
    for step in range(1, steps + 1):
        ts = time.perf_counter()
        b = batch_to_device(next(pipe), dev)
        params, opt_state, metrics = step_fn(params, opt_state, b, step)
        if cuda:
            torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - ts)
        tokens_seen += batch * seq
        losses.append(metrics["loss"])
        gnorms.append(metrics["grad_norm"])
        if step % log_every == 0 or step == 1:
            rate = tokens_seen / (time.perf_counter() - t0)
            log(f"step {step:5d} loss={float(metrics['loss']):.4f} "
                f"gnorm={float(metrics['grad_norm']):.3f} "
                f"lr={metrics['lr']:.2e} tok/s={rate:,.0f}")
        if ckpt and step % ckpt_every == 0:
            save_checkpoint(ckpt, step, params, opt_state, {"arch": cfg.name})
            log(f"  checkpoint @ {step} -> {ckpt}")
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    log(f"done: {steps} steps, {tokens_seen:,} tokens, {seconds:.1f}s"
        + (f", peak memory {peak / 2**30:.2f} GiB" if cuda else ""))
    return {"losses": [float(x) for x in losses], "grad_norms": [float(x) for x in gnorms],
            "step_s": step_s, "median_step_s": float(np.median(step_s)),
            "tokens_per_s": tokens_seen / seconds, "seconds": seconds,
            "peak_bytes": peak, "params": params, "opt_state": opt_state}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=ASSIGNED_ARCHS)
    ap.add_argument("--reduce", action="store_true",
                    help="train the reduced (smoke-size) variant")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--text", default=None, help="optional text corpus path")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    ap.add_argument("--backend", choices=("kernel", "eager"), default="kernel")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduced(cfg, d_model=args.d_model)
    else:
        check_fits_one_card(cfg)
    print(f"training {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"params={cfg.param_count()/1e6:.1f}M on {dev} ({args.backend} backend)")
    out = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
                warmup=args.warmup, ckpt=args.ckpt, ckpt_every=args.ckpt_every,
                log_every=args.log_every, text=args.text, device=dev,
                backend=args.backend)
    if not all(math.isfinite(x) for x in out["losses"]):
        raise SystemExit("a loss was not finite")
    return out


if __name__ == "__main__":
    main()
