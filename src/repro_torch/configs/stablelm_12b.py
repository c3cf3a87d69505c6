"""stablelm-12b [dense] — 40L d_model=5120 32H (GQA kv=8, head dim 160)
d_ff=13824 vocab=100352, LayerNorm, untied embeddings.
[hf:stabilityai/stablelm-2-1_6b family card, 12B variant]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    block_pattern=("attn",),
    norm="layernorm",
    activation="swiglu",
    dtype="bfloat16",
    param_dtype="bfloat16",
)
