"""The training data pipeline and tokenizer (counterpart of
``src/repro/data/``), pure numpy: its batches are bitwise the
reference's for the same seed."""
from repro_torch.data.pipeline import DataConfig, LMDataPipeline
from repro_torch.data.tokenizer import ByteTokenizer

__all__ = ["DataConfig", "LMDataPipeline", "ByteTokenizer"]
