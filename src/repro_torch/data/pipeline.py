"""Data pipeline: synthetic LM streams and text-file corpora, packed into
fixed-shape (B, S) batches with next-token labels.

Synthetic mode draws from a Zipfian unigram distribution with a Markov
bigram structure, so the loss curve has a learnable signal.  The
``embed``-input archs (musicgen-medium) get deterministic
pseudo-embedding features of the token ids, and one label per codebook;
the VLM archs (llama-3.2-vision) get random image embeddings.  Host
sharding: each process takes its own stream (``process_index``).

Pure numpy, the reference's draws in the reference's order, so a batch is
bitwise the reference's for the same seed.  Batches are numpy arrays; the
trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.data.tokenizer import ByteTokenizer


@dataclasses.dataclass
class DataConfig:
    batch_size: int = 8
    seq_len: int = 128
    seed: int = 0
    text_path: Optional[str] = None
    process_index: int = 0
    process_count: int = 1


def _zipf_markov_stream(rng: np.random.Generator, vocab: int, n: int) -> np.ndarray:
    """Zipf unigram + shift-structured bigram: token t+1 is correlated with
    token t, giving a model something learnable."""
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    base = rng.choice(vocab, size=n, p=probs)
    out = base.copy()
    stay = rng.random(n) < 0.5
    out[1:][stay[1:]] = (out[:-1][stay[1:]] + 1) % vocab
    return out.astype(np.int32)


class LMDataPipeline:
    def __init__(self, cfg: ModelConfig, data_cfg: DataConfig):
        self.cfg = cfg
        self.data_cfg = data_cfg
        self.tokenizer = ByteTokenizer()
        self._text_ids: Optional[np.ndarray] = None
        if data_cfg.text_path:
            with open(data_cfg.text_path, "rb") as f:
                raw = f.read()
            self._text_ids = np.frombuffer(raw, dtype=np.uint8).astype(np.int32)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        dc = self.data_cfg
        rng = np.random.default_rng(dc.seed + 7919 * dc.process_index)
        b, s = dc.batch_size, dc.seq_len
        vocab = min(self.cfg.vocab_size, 4096)
        while True:
            if self._text_ids is not None and len(self._text_ids) > (s + 1):
                starts = rng.integers(0, len(self._text_ids) - s - 1, size=b)
                chunk = np.stack([self._text_ids[i : i + s + 1] for i in starts])
            else:
                chunk = _zipf_markov_stream(rng, vocab, b * (s + 1)).reshape(b, s + 1)
            tokens, labels = chunk[:, :-1], chunk[:, 1:]
            batch: Dict[str, np.ndarray] = {"labels": np.ascontiguousarray(labels)}
            if self.cfg.input_mode == "token":
                batch["tokens"] = np.ascontiguousarray(tokens)
            else:
                # stubbed modality frontend: deterministic pseudo-embeddings
                batch["embeds"] = _token_features(tokens, self.cfg.d_model)
                if self.cfg.num_codebooks > 1:
                    cb = self.cfg.num_codebooks
                    batch["labels"] = np.stack(
                        [(labels + i) % self.cfg.vocab_size for i in range(cb)], axis=-1
                    ).astype(np.int32)
            if self.cfg.num_image_tokens:
                img_rng = np.random.default_rng(dc.seed + 13)
                batch["img_embeds"] = img_rng.standard_normal(
                    (b, self.cfg.num_image_tokens, self.cfg.d_model), dtype=np.float32
                ) * 0.1
            yield batch


def _token_features(tokens: np.ndarray, d: int) -> np.ndarray:
    """Deterministic pseudo-embedding of a token id (stub frontend)."""
    phase = tokens[..., None].astype(np.float32)
    freqs = np.arange(1, d + 1, dtype=np.float32) / d
    return (np.sin(phase * freqs * 0.1) * 0.3).astype(np.float32)
