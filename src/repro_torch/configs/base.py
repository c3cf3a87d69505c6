"""Model configuration: the fields of the reference ``ModelConfig`` that the
Galaxy serving path reads (dims, block type, numerics)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    source: str  # citation for the config (paper / model card)

    num_layers: int = 12
    d_model: int = 768
    num_heads: int = 12
    num_kv_heads: int = 12
    d_ff: int = 3072
    vocab_size: int = 32000
    head_dim: int = 0          # 0 -> d_model // num_heads
    activation: str = "gelu"   # gelu (2 MLP matrices) | swiglu | geglu (3)
    dtype: str = "float16"     # serving dtype

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError("num_heads must be divisible by num_kv_heads")
