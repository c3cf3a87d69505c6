"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512/expert,
vocab=49155, MoE 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base] (granite-3.0 MoE family scaled per
assignment; 40-expert top-8 variant)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,                 # per-expert width
    vocab_size=49155,
    num_experts=40,           # padded to 48 in the parameter tree (models/params.py)
    experts_per_token=8,
    block_pattern=("attn",),
    norm="rmsnorm",
    activation="swiglu",
    tie_embeddings=True,
    dtype="bfloat16",
    param_dtype="bfloat16",
)
