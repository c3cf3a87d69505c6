"""Byte-level tokenizer: 256 byte tokens + BOS/EOS/PAD specials.
Self-contained (no external vocab files) and reversible; the reference's
ids."""
from __future__ import annotations

from typing import List

PAD_ID = 256
BOS_ID = 257
EOS_ID = 258
VOCAB_SIZE = 259


class ByteTokenizer:
    vocab_size = VOCAB_SIZE
    pad_id = PAD_ID
    bos_id = BOS_ID
    eos_id = EOS_ID

    def encode(self, text: str, add_bos: bool = True, add_eos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids = [BOS_ID] + ids
        if add_eos:
            ids = ids + [EOS_ID]
        return ids

    def decode(self, ids) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")
