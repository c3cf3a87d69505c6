"""The dry run's input shapes and their fake stand-ins (counterpart of
``src/repro/launch/shapes.py``).

  train_4k       seq_len=  4,096  global_batch= 256  (training)
  prefill_32k    seq_len= 32,768  global_batch=  32  (inference-prefill)
  decode_32k     seq_len= 32,768  global_batch= 128  (inference-decode)
  long_500k      seq_len=524,288  global_batch=   1  (long-context-decode)

The decode shapes run ``serve_step``: ONE token against a cache of
seq_len.  long_500k puts the sliding-window attention variant in place of
the quadratic attention of archs that have it; their cache is then
window-sized.

Where the reference gives ``jax.ShapeDtypeStruct``s with shardings, here
each input is a fake tensor (nothing allocated), under a mesh a
``DTensor`` over a fake local shard (``models/sharding.py:abstract_tensor``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.sharding import Rules, abstract_tensor, fake_mode
from repro_torch.serving.kvcache import make_cache

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, mode="train"),
    "prefill_32k": dict(seq=32768, batch=32, mode="prefill"),
    "decode_32k": dict(seq=32768, batch=128, mode="decode"),
    "long_500k": dict(seq=524288, batch=1, mode="decode_long"),
}


def shape_config(cfg: ModelConfig, shape: str) -> ModelConfig:
    """Per-shape config: long_500k swaps in sliding-window attention for
    archs whose native attention is quadratic."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return dataclasses.replace(cfg, window=cfg.long_context_window)
    return cfg


def input_specs(cfg: ModelConfig, shape, rules: Optional[Rules] = None) -> Dict:
    """Fake stand-ins for every model input of a shape (a name of
    :data:`SHAPES`, or a dict of its ``seq``, ``batch`` and ``mode``):
    token ids and labels int32 (as the reference's; ``apply_model`` widens
    them), embeddings in the model dtype, and for the decode shapes the
    cache of ``seq`` (from ``make_cache(abstract=True)``) and its write
    index ``cache_index`` (a host int: the last slot)."""
    info = SHAPES[shape] if isinstance(shape, str) else shape
    seq, batch, mode = info["seq"], info["batch"], info["mode"]
    if isinstance(shape, str):
        cfg = shape_config(cfg, shape)
    dt = getattr(torch, cfg.dtype)
    ids = torch.int32
    specs: Dict = {}

    def sds(shp, dtype, axes):
        return abstract_tensor(shp, dtype, rules, axes)

    with fake_mode():
        if mode in ("train", "prefill"):
            if cfg.input_mode == "token":
                specs["tokens"] = sds((batch, seq), ids, ("batch", "seq"))
            else:
                specs["embeds"] = sds((batch, seq, cfg.d_model), dt, ("batch", "seq", "embed"))
            if mode == "train":
                if cfg.input_mode == "token" or cfg.num_codebooks <= 1:
                    specs["labels"] = sds((batch, seq), ids, ("batch", "seq"))
                else:
                    specs["labels"] = sds((batch, seq, cfg.num_codebooks), ids,
                                          ("batch", "seq", None))
        else:  # decode / decode_long
            if cfg.input_mode == "token":
                specs["tokens"] = sds((batch, 1), ids, ("batch", None))
            else:
                specs["embeds"] = sds((batch, 1, cfg.d_model), dt, ("batch", None, "embed"))
            specs["cache"] = make_cache(cfg, batch, seq, abstract=True, rules=rules)
            specs["cache_index"] = seq - 1
        if cfg.num_image_tokens:
            specs["img_embeds"] = sds((batch, cfg.num_image_tokens, cfg.d_model), dt,
                                      ("batch", "img_seq", "embed"))
    return specs
