"""Token samplers (greedy / temperature / top-k) over (B, V) logits.

Randomness comes only from the explicit ``torch.Generator`` the caller
passes (on the logits' device), never from global RNG state.  Greedy
sampling consumes none, which is what lets greedy tokens be compared with
the reference package (``jax.random`` streams have no PyTorch twin).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0   # 0 = greedy
    top_k: int = 0             # 0 = full distribution


def sample(logits: torch.Tensor, generator: torch.Generator,
           cfg: SamplerConfig) -> torch.Tensor:
    """logits: (B, V) -> (B,) int64 token ids."""
    if cfg.temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / cfg.temperature
    if cfg.top_k > 0:
        cutoff = torch.topk(logits, cfg.top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits >= cutoff, logits,
                             torch.full((), -1e30, device=logits.device))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def sample_positions(logits: torch.Tensor, generator: torch.Generator,
                     cfg: SamplerConfig) -> torch.Tensor:
    """Sample every position of a (B, K, V) logits block -> (B, K).

    The speculative verify chunk scores all K positions in one call and
    needs a token per position.  At ``temperature == 0`` this is the
    per-position argmax and draws nothing from ``generator``, which is what
    pins speculative greedy output to the sequential path."""
    if cfg.temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    return torch.stack([sample(logits[:, j], generator, cfg)
                        for j in range(logits.shape[1])], dim=1)
