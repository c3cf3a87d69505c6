"""codeqwen1.5-7b [dense] — 32L d_model=4096 32H (GQA kv=32) d_ff=13440
vocab=92416, QKV bias. [hf:Qwen/CodeQwen1.5-7B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    source="hf:Qwen/CodeQwen1.5-7B",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    block_pattern=("attn",),
    norm="rmsnorm",
    activation="swiglu",
    qkv_bias=True,
    dtype="bfloat16",
    param_dtype="bfloat16",
)
