"""Quickstart: the assigned architectures, a forward pass of one of them,
and the Galaxy HMP sharding plan in one line per logical axis.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ASSIGNED_ARCHS, get_config, reduced
from repro_torch.models.params import init_params, param_bytes
from repro_torch.models.sharding import make_rules
from repro_torch.models.transformer import apply_model


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("assigned architectures:")
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        print(f"  {arch:24s} [{cfg.family:6s}] {cfg.num_layers}L d={cfg.d_model} "
              f"params={cfg.param_count() / 1e9:.2f}B "
              f"weights={param_bytes(cfg) / 1e9:.1f}GB ({cfg.param_dtype})")

    # a reduced model end to end on the device
    cfg = reduced(get_config("qwen1.5-0.5b"))
    print(f"\nforward pass on {cfg.name} ({cfg.param_count() / 1e6:.1f}M params) on {dev}...")
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32))
    with torch.no_grad():
        logits, _ = apply_model(params, cfg, tokens=tokens, mode="train")
    finite = bool(torch.isfinite(logits).all())
    print(f"logits: {tuple(logits.shape)}, finite: {finite}")

    rules = make_rules(None, "train")
    print("\nGalaxy HMP logical->mesh mapping (train):")
    for k in ("heads", "ffn", "experts", "seq", "batch", "embed_w"):
        print(f"  {k:10s} -> {rules.mapping[k]}")
    print("TP blocks (heads/ffn/experts on 'model') + SP connective (seq on"
          " 'model')\n= AllGather entering / ReduceScatter exiting each TP"
          " block — paper Fig. 5.")
    return {"logits_shape": tuple(logits.shape), "finite": finite}


if __name__ == "__main__":
    main()
