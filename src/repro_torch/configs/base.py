"""Model configuration: the fields of the reference ``ModelConfig`` that the
port reads — the Galaxy serving path (dims, numerics) and the model zoo
(block pattern, norm, positions, window, RG-LRU widths).

``block_pattern`` is the repeating unit of the layer stack, e.g.
``("attn",)`` for a dense stack or ``("rec", "rec", "attn")`` for
RecurrentGemma.  ``num_layers`` need not be a multiple of its length: the
remainder (``tail_pattern``) runs as individual blocks after the groups
(see ``models/transformer.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

# block kinds the port's zoo implements (the reference also has xattn,
# mlstm and slstm: ROADMAP queue 1, item 11)
BLOCK_KINDS = ("attn", "rec")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    source: str  # citation for the config (paper / model card)
    family: str = "dense"  # dense | hybrid

    num_layers: int = 12
    d_model: int = 768
    num_heads: int = 12
    num_kv_heads: int = 12
    d_ff: int = 3072
    vocab_size: int = 32000
    head_dim: int = 0          # 0 -> d_model // num_heads

    block_pattern: Tuple[str, ...] = ("attn",)
    norm: str = "rmsnorm"      # rmsnorm | layernorm
    activation: str = "gelu"   # gelu (2 MLP matrices) | swiglu | geglu (3)
    qkv_bias: bool = False
    tie_embeddings: bool = False
    pos_embedding: str = "rope"  # rope | sinusoidal | none
    rope_theta: float = 10000.0

    window: int = 0            # 0 = full causal; >0 = sliding window
    lru_width: int = 0         # 0 -> d_model
    conv_width: int = 4

    input_mode: str = "token"  # token ids (the only mode the port serves)
    dtype: str = "float16"     # serving dtype
    param_dtype: str = "float16"
    # the reference's query-chunked prefill attention (0 = off), which caps
    # its (S, S) score buffer; the port's prefill runs the flash kernel,
    # which never holds that buffer, so the zoo needs no chunking
    attn_chunk: int = 0

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)
        for kind in self.block_pattern:
            if kind not in BLOCK_KINDS:
                raise ValueError(f"unknown block kind {kind!r}")
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError("num_heads must be divisible by num_kv_heads")

    def padded_vocab(self, multiple: int = 256) -> int:
        """Vocab rounded up to ``multiple``."""
        return _round_up(self.vocab_size, multiple)

    @property
    def num_groups(self) -> int:
        return self.num_layers // len(self.block_pattern)

    @property
    def tail_pattern(self) -> Tuple[str, ...]:
        r = self.num_layers % len(self.block_pattern)
        return self.block_pattern[:r]

    def layer_kinds(self) -> Tuple[str, ...]:
        """Kind of every layer, in order."""
        return self.block_pattern * self.num_groups + self.tail_pattern

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks + head), as the
        reference counts it."""
        d, hd = self.d_model, self.head_dim
        h, kv = self.num_heads, self.num_kv_heads
        n = 0
        if self.input_mode == "token":
            n += self.vocab_size * d
        if not self.tie_embeddings:
            n += self.vocab_size * d
        gate_mats = {"swiglu": 3, "geglu": 3, "gelu": 2}[self.activation]
        for kind in self.layer_kinds():
            if kind == "attn":
                n += d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d  # qkvo
                if self.d_ff > 0:
                    n += gate_mats * d * self.d_ff
            elif kind == "rec":
                w = self.lru_width
                n += 2 * d * w + w * d          # in/out projections (gated)
                n += self.conv_width * w + 3 * w  # conv + lru gates
                n += gate_mats * d * self.d_ff    # hybrid blocks keep MLP
        return int(n)


def reduced(cfg: ModelConfig, d_model: int = 256, vocab: int = 512) -> ModelConfig:
    """Smoke-test variant: one pattern group of layers (>=2 for dense),
    d_model <= 512 — the same code paths, CPU-runnable."""
    pat = cfg.block_pattern
    layers = max(2, len(pat))
    heads = min(cfg.num_heads, 4)
    kv = min(cfg.num_kv_heads, heads)
    while heads % kv:
        kv -= 1
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=0,
        d_ff=0 if cfg.d_ff == 0 else max(64, d_model * 2),
        vocab_size=vocab,
        lru_width=0,
        window=min(cfg.window, 32) if cfg.window else 0,
        dtype="float32",
        param_dtype="float32",
    )
