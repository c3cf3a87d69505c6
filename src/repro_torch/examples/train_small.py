"""A small end-to-end training run with checkpoints: qwen1.5-0.5b reduced
to d_model 512 (~100M parameters with its 151k vocabulary reduced; rope,
GQA, swiglu and tied embeddings kept) for a few hundred steps on the data
pipeline's synthetic stream, through ``repro_torch.launch.train``.

    PYTHONPATH=src python -m repro_torch.examples.train_small [--steps 300] [--device cpu]

Checkpoints go to ``experiments/train_small_torch/`` in the checkout
unless ``--ckpt`` names another directory.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from repro_torch.launch import train

CKPT = Path(__file__).resolve().parents[3] / "experiments" / "train_small_torch"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    ap.add_argument("--ckpt", default=str(CKPT))
    args = ap.parse_args(argv)
    flags = ["--arch", "qwen1.5-0.5b", "--reduce", "--d-model", "512", "--steps",
             str(args.steps), "--batch", "8", "--seq", "128", "--ckpt", args.ckpt,
             "--ckpt-every", "100"]
    if args.device:
        flags += ["--device", args.device]
    return train.main(flags)


if __name__ == "__main__":
    main()
