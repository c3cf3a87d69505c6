"""xlstm-350m [ssm] — 24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304.
Alternating mLSTM (chunkwise-parallel matrix memory) and sLSTM (sequential
scalar memory with exponential gating) blocks. d_ff=0: the up/down
projections live inside each block (proj_factor=2). [arXiv:2405.04517]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    source="arXiv:2405.04517",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "slstm"),
    proj_factor=2.0,
    mlstm_chunk=128,
    norm="layernorm",
    activation="gelu",
    pos_embedding="none",     # recurrence encodes position
    dtype="bfloat16",
    param_dtype="bfloat16",
)
