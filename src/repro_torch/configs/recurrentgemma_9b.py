"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000. Griffin-style RG-LRU + local attention at a 2:1 ratio
(pattern rec,rec,attn; 38 = 12 groups of 3 + 2 trailing rec blocks).
Local attention window 2048. [arXiv:2402.19427]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    source="arXiv:2402.19427",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,             # griffin uses wide heads (16*256 = 4096)
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rec", "rec", "attn"),
    window=2048,              # local attention — natively sub-quadratic
    lru_width=4096,
    conv_width=4,
    norm="rmsnorm",
    activation="geglu",
    tie_embeddings=True,
    pos_embedding="rope",
    dtype="bfloat16",
    param_dtype="bfloat16",
)
