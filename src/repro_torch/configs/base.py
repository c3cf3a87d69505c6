"""Model configuration: the fields of the reference ``ModelConfig`` that the
port reads — the Galaxy serving path (dims, numerics), the model zoo
(block pattern, norm, positions, window, RG-LRU widths, MoE experts,
xLSTM projections, the stubbed multimodal frontends) and training
(dropout, the MoE load-balance weight, rematerialization).

``block_pattern`` is the repeating unit of the layer stack, e.g.
``("attn",)`` for a dense or MoE stack, ``("rec", "rec", "attn")`` for
RecurrentGemma or ``("mlstm", "slstm")`` for xLSTM, ``("attn",) * 4 + ("xattn",)`` for
Llama-3.2-Vision (cross-attention to image embeddings every 5th layer).  ``num_layers``
need not be a multiple of its length: the remainder (``tail_pattern``)
runs as individual blocks after the groups (see
``models/transformer.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

ATTN_KINDS = ("attn", "xattn")
RECURRENT_KINDS = ("rec", "mlstm", "slstm")
BLOCK_KINDS = ATTN_KINDS + RECURRENT_KINDS


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    source: str  # citation for the config (paper / model card)
    family: str = "dense"  # dense | moe | hybrid | ssm | vlm | audio

    num_layers: int = 12
    d_model: int = 768
    num_heads: int = 12
    num_kv_heads: int = 12
    d_ff: int = 3072          # dense MLP width; for MoE: per-expert width
    vocab_size: int = 32000
    head_dim: int = 0          # 0 -> d_model // num_heads

    block_pattern: Tuple[str, ...] = ("attn",)
    norm: str = "rmsnorm"      # rmsnorm | layernorm
    activation: str = "gelu"   # gelu (2 MLP matrices) | swiglu | geglu (3)
    qkv_bias: bool = False
    tie_embeddings: bool = False
    pos_embedding: str = "rope"  # rope | sinusoidal | none
    rope_theta: float = 10000.0
    dropout_rate: float = 0.0  # the connective block's dropout (training only)

    window: int = 0            # 0 = full causal; >0 = sliding window
    # the sliding window put in place of full attention only for the dry
    # run's long_500k shape on archs whose attention is quadratic
    long_context_window: int = 4096

    num_experts: int = 0
    experts_per_token: int = 0
    load_balance_loss_weight: float = 0.01
    moe_capacity_factor: float = 2.0   # GShard capacity

    lru_width: int = 0         # 0 -> d_model
    conv_width: int = 4

    proj_factor: float = 2.0   # up-projection inside m/sLSTM blocks
    mlstm_chunk: int = 128     # chunkwise-parallel scan chunk

    # "token": inputs are int token ids; "embed": precomputed frontend
    # embeddings (B, S, d_model) — the stubbed audio / vision frontends
    input_mode: str = "token"
    num_image_tokens: int = 0  # vlm: patch embeddings fed to cross-attention
    num_codebooks: int = 0     # audio: parallel codebook heads (0 = one head)

    dtype: str = "float16"     # compute dtype
    param_dtype: str = "float16"
    remat: bool = True         # recompute each block group in training's backward
    # "full" recomputes everything, "dots" keeps the outputs of products
    # with no batch dimension (the reference's
    # dots_with_no_batch_dims_saveable), "none" keeps every activation
    remat_policy: str = "full"
    # the reference's query-chunked attention (0 = off): train and one-shot
    # prefill on the eager backend take the queries this many rows at a
    # time, a (B, H, chunk, S) score buffer; the flash kernel never holds one
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

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def padded_vocab(self, multiple: int = 256) -> int:
        """Vocab rounded up to ``multiple``."""
        return _round_up(self.vocab_size, multiple)

    def padded_experts(self, multiple: int) -> int:
        """Experts rounded up to ``multiple`` (pad experts get -1e30 router
        logits and are never selected); 0 without experts."""
        if not self.is_moe:
            return 0
        return _round_up(self.num_experts, multiple)

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

    def count_kind(self, kind: str) -> int:
        return sum(1 for k in self.layer_kinds() if k == kind)

    @property
    def sub_quadratic(self) -> bool:
        """True if prefill and decode cost is sub-quadratic in the sequence
        natively (recurrent blocks and windowed attention only)."""
        return all(k not in ATTN_KINDS or self.window > 0 for k in self.block_pattern)

    def param_count(self, active_only: bool = False) -> int:
        """Approximate parameter count (embedding + blocks + head), as the
        reference counts it: real experts only (not the padded ones), and
        with ``active_only`` the ``experts_per_token`` a token reaches."""
        d, hd = self.d_model, self.head_dim
        h, kv = self.num_heads, self.num_kv_heads
        n = 0
        if self.input_mode == "token":
            n += self.vocab_size * d
        if not self.tie_embeddings:
            n += self.vocab_size * d * max(1, self.num_codebooks)
        gate_mats = {"swiglu": 3, "geglu": 3, "gelu": 2}[self.activation]
        for kind in self.layer_kinds():
            if kind in ATTN_KINDS:
                n += d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d  # qkvo
                if self.is_moe:
                    e = self.experts_per_token if active_only else self.num_experts
                    n += e * gate_mats * d * self.d_ff + d * self.num_experts
                elif self.d_ff > 0:
                    n += gate_mats * d * self.d_ff
            elif kind == "rec":
                w = self.lru_width
                n += 2 * d * w + w * d          # in/out projections (gated)
                n += self.conv_width * w + 3 * w  # conv + lru gates
                n += gate_mats * d * self.d_ff    # hybrid blocks keep MLP
            elif kind == "mlstm":
                di = int(d * self.proj_factor)
                n += 2 * d * di + di * d + 3 * di * di // max(self.num_heads, 1)
            elif kind == "slstm":
                di = int(d * self.proj_factor)
                n += d * 4 * di + di * 4 * di + di * d  # in, recurrent, out
        return int(n)


def reduced(cfg: ModelConfig, d_model: int = 256, vocab: int = 512) -> ModelConfig:
    """Smoke-test variant: one pattern group of layers (>=2 for dense),
    d_model <= 512, <= 4 experts of which 2 per token, <= 16 image tokens,
    no rematerialization — the same code paths, CPU-runnable."""
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
        num_experts=min(cfg.num_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        lru_width=0,
        window=min(cfg.window, 32) if cfg.window else 0,
        long_context_window=64,
        num_image_tokens=min(cfg.num_image_tokens, 16),
        dtype="float32",
        param_dtype="float32",
        remat=False,
    )
