"""musicgen-medium [audio] — 48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048.
Decoder-only transformer over EnCodec tokens.  The EnCodec conv codec
frontend is stubbed: the model takes precomputed frame embeddings (B, S,
d_model) and predicts 4 parallel codebooks of 2048 codes each.
[arXiv:2306.05284]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    source="arXiv:2306.05284",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    block_pattern=("attn",),
    norm="layernorm",
    activation="gelu",
    pos_embedding="sinusoidal",
    input_mode="embed",       # EnCodec frontend stub
    num_codebooks=4,
    dtype="bfloat16",
    param_dtype="bfloat16",
)
