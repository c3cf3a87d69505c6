"""qwen1.5-0.5b [dense] — 24L d_model=1024 16H (kv=16) d_ff=2816
vocab=151936, QKV bias, tied embeddings. [hf:Qwen/Qwen1.5-0.5B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    block_pattern=("attn",),
    norm="rmsnorm",
    activation="swiglu",
    qkv_bias=True,
    tie_embeddings=True,
    dtype="bfloat16",
    param_dtype="bfloat16",
)
