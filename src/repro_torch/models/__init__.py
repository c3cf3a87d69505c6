"""The model zoo on one device: parameters, blocks and ``apply_model``
(counterpart of ``src/repro/models/``).  The port serves RecurrentGemma
(``attn`` and ``rec`` blocks); MoE, xLSTM and cross-attention are ROADMAP
queue 1, item 11."""
from repro_torch.models.params import init_params, model_spec, params_from_numpy
from repro_torch.models.transformer import apply_model

__all__ = ["apply_model", "init_params", "model_spec", "params_from_numpy"]
