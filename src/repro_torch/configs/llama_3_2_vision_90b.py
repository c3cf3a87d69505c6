"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256.  Cross-attention image layers interleaved with
self-attention (pattern: 4 self + 1 cross, 20 groups = 100 layers).  The
vision encoder and projector are stubbed: the model takes precomputed
patch embeddings (B, num_image_tokens, d_model).
[hf:meta-llama/Llama-3.2-11B-Vision, 90B variant]

Its bf16 weights (about 180 GB) fit no single card: ``launch.train``
takes it only with ``--reduce``, and ``launch.serve`` refuses it (serving
feeds no image embeddings)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    block_pattern=("attn", "attn", "attn", "attn", "xattn"),
    norm="rmsnorm",
    activation="swiglu",
    num_image_tokens=1024,    # stubbed vision frontend output length
    dtype="bfloat16",
    param_dtype="bfloat16",
)
