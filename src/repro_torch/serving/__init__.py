"""Serving: continuous batching over a paged KV pool and waves over dense
caches, for the Galaxy HMP executor and the model zoo's
``TransformerExecutor``, with the prefix cache, chunked prefill and
speculative decoding."""
from repro_torch.serving.engine import Request, ServingEngine, TransformerExecutor
from repro_torch.serving.galaxy import GalaxyHMPExecutor
from repro_torch.serving.kvpool import PagedKVPool, PoolExhausted
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.sampler import SamplerConfig, sample, sample_positions
from repro_torch.serving.spec import (
    SpeculativeDecoder,
    longest_accepted_prefix,
    place_draft,
    run_spec_round,
)

__all__ = [
    "GalaxyHMPExecutor", "PagedKVPool", "PoolExhausted", "PrefixCache", "Request",
    "SamplerConfig", "ServingEngine", "SpeculativeDecoder", "TransformerExecutor",
    "longest_accepted_prefix", "place_draft", "run_spec_round", "sample",
    "sample_positions",
]
