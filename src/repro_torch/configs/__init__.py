"""Model configurations the port serves: the Galaxy paper's Table IV models."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig  # noqa: F401
from repro_torch.configs.paper_models import PAPER_MODELS


def get_config(name: str) -> ModelConfig:
    if name in PAPER_MODELS:
        return PAPER_MODELS[name]
    raise KeyError(f"unknown model {name!r}; known: {sorted(PAPER_MODELS)}")
