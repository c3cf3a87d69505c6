"""qwen1.5-110b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064, QKV bias. [hf:Qwen/Qwen1.5-0.5B family card, 110B variant]

Its bf16 weights (about 222 GB) do not fit one card: ``launch.serve``
refuses it until the port serves across cards."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    block_pattern=("attn",),
    norm="rmsnorm",
    activation="swiglu",
    qkv_bias=True,
    dtype="bfloat16",
    param_dtype="bfloat16",
)
