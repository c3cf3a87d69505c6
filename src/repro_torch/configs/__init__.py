"""Model configurations the port serves: the Galaxy paper's Table IV models
(Galaxy HMP path) and the model zoo's RecurrentGemma-9B."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, reduced  # noqa: F401
from repro_torch.configs.paper_models import PAPER_MODELS
from repro_torch.configs.recurrentgemma_9b import CONFIG as RECURRENTGEMMA_9B

#: the zoo architectures the port serves, by their public ids
ZOO_MODELS = {"recurrentgemma-9b": RECURRENTGEMMA_9B}


def get_config(name: str) -> ModelConfig:
    if name in PAPER_MODELS:
        return PAPER_MODELS[name]
    if name in ZOO_MODELS:
        return ZOO_MODELS[name]
    raise KeyError(f"unknown model {name!r}; known: "
                   f"{sorted(PAPER_MODELS) + sorted(ZOO_MODELS)}")
