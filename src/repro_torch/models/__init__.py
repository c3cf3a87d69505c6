"""The model zoo on one device: parameters, blocks and ``apply_model``
(counterpart of ``src/repro/models/``).  The port serves ``attn``, ``rec``,
``mlstm`` and ``slstm`` blocks, dense or MoE FFNs; cross-attention is
ROADMAP queue 1, item 7."""
from repro_torch.models.params import init_params, model_spec, params_from_numpy
from repro_torch.models.transformer import apply_model

__all__ = ["apply_model", "init_params", "model_spec", "params_from_numpy"]
