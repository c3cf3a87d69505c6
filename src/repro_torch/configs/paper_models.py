"""The five Transformer models the Galaxy paper evaluates (Table IV).

All are stacks of the Fig. 2 layer: MHA block + MLP block joined by
connective (dropout/residual/layernorm) blocks — exactly what HMP
partitions.
"""
from repro_torch.configs.base import ModelConfig


def _paper_model(name: str, layers: int, heads: int, hidden: int) -> ModelConfig:
    return ModelConfig(
        name=name,
        source="Galaxy paper Table IV",
        family="dense",
        num_layers=layers,
        d_model=hidden,
        num_heads=heads,
        num_kv_heads=heads,
        d_ff=4 * hidden,           # paper §II-A: MLP expands h -> 4h -> h
        vocab_size=50304,
        norm="layernorm",
        activation="gelu",
        pos_embedding="sinusoidal",
        dtype="float16",           # paper runs fp16 (§II-B GPT2-L footprint)
    )


DISTILBERT = _paper_model("distilbert", 6, 12, 768)
BERT_L = _paper_model("bert-l", 24, 16, 1024)
GPT2_L = _paper_model("gpt2-l", 36, 20, 1280)
OPT_L = _paper_model("opt-l", 24, 16, 2048)
OPT_XL = _paper_model("opt-xl", 32, 32, 2560)

PAPER_MODELS = {
    "distilbert": DISTILBERT,
    "bert-l": BERT_L,
    "gpt2-l": GPT2_L,
    "opt-l": OPT_L,
    "opt-xl": OPT_XL,
}
