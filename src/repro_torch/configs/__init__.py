"""Model configurations of the port: the Galaxy paper's Table IV models
(Galaxy HMP path) and the reference's ten assigned architectures.  The
zoo serves eight of them (RecurrentGemma-9B and xLSTM-350M in waves; the
dense GQA stacks and the MoE stacks, OLMoE and Granite-MoE, through the
paged continuous scheduler); the trainer takes all ten
(``ASSIGNED_ARCHS``), musicgen-medium and llama-3.2-vision-90b through
their stubbed frontends."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, reduced  # noqa: F401
from repro_torch.configs.codeqwen1_5_7b import CONFIG as CODEQWEN1_5_7B
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as GRANITE_MOE_3B_A800M
from repro_torch.configs.llama_3_2_vision_90b import CONFIG as LLAMA_3_2_VISION_90B
from repro_torch.configs.musicgen_medium import CONFIG as MUSICGEN_MEDIUM
from repro_torch.configs.olmoe_1b_7b import CONFIG as OLMOE_1B_7B
from repro_torch.configs.paper_models import PAPER_MODELS
from repro_torch.configs.qwen1_5_0_5b import CONFIG as QWEN1_5_0_5B
from repro_torch.configs.qwen1_5_110b import CONFIG as QWEN1_5_110B
from repro_torch.configs.recurrentgemma_9b import CONFIG as RECURRENTGEMMA_9B
from repro_torch.configs.stablelm_12b import CONFIG as STABLELM_12B
from repro_torch.configs.xlstm_350m import CONFIG as XLSTM_350M

#: the zoo architectures the port serves, by their public ids
ZOO_MODELS = {c.name: c for c in (RECURRENTGEMMA_9B, QWEN1_5_0_5B, CODEQWEN1_5_7B,
                                  STABLELM_12B, QWEN1_5_110B, OLMOE_1B_7B,
                                  GRANITE_MOE_3B_A800M, XLSTM_350M)}
#: the architectures with a stubbed frontend, which only the trainer drives
FRONTEND_STUB_MODELS = {c.name: c for c in (MUSICGEN_MEDIUM, LLAMA_3_2_VISION_90B)}
_ASSIGNED = {**ZOO_MODELS, **FRONTEND_STUB_MODELS}
#: the reference's assigned architectures, in its order (the trainer's choices)
ASSIGNED_ARCHS = ("granite-moe-3b-a800m", "codeqwen1.5-7b", "recurrentgemma-9b",
                  "musicgen-medium", "olmoe-1b-7b", "qwen1.5-110b", "qwen1.5-0.5b",
                  "stablelm-12b", "llama-3.2-vision-90b", "xlstm-350m")


def get_config(name: str) -> ModelConfig:
    if name in PAPER_MODELS:
        return PAPER_MODELS[name]
    if name in _ASSIGNED:
        return _ASSIGNED[name]
    raise KeyError(f"unknown model {name!r}; known: "
                   f"{sorted(PAPER_MODELS) + sorted(_ASSIGNED)}")
