"""Training step: loss (cross-entropy over one or several codebook heads,
plus the MoE aux losses), gradients, AdamW update (counterpart of
``src/repro/training/train_loop.py``).

The reference's ``_nll`` is a ``jax.custom_vjp`` that keeps one (..., V)
buffer in each direction: the shifted exponentials in the model dtype
forward, the softmax backward, with the label's -g scattered in (no
one-hot buffer).  Here it is :class:`NLL`, a ``torch.autograd.Function``
with the same arithmetic.  ``rules`` (``models/sharding.py``) lay the
step over a mesh, as the reference's do; without them the step runs on
one device.

The gradient of ``apply_model`` comes from ``torch.autograd``: on the
kernel backend the flash attention and the RG-LRU scan go through their
``autograd.Function``s (``kernels/flash_attention.py``,
``kernels/rglru_scan.py``), on the eager backend through their plain
versions.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import DropoutStream
from repro_torch.models.moe import AUX_KEYS
from repro_torch.models.sharding import Rules, axis_rules, by_rows
from repro_torch.models.transformer import apply_model
from repro_torch.training.optimizer import AdamW, tree_leaves


class NLL(torch.autograd.Function):
    """Per-token negative log-likelihood.  logits: (..., V) in the model
    dtype; labels: (...) int (callers clamp padding to 0 and mask
    outside).  Returns fp32 (...)."""

    @staticmethod
    def forward(ctx, logits, labels):
        m = logits.amax(dim=-1)
        p = torch.exp(logits - m[..., None])  # model dtype: the one buffer
        sumexp = p.sum(dim=-1, dtype=torch.float32)
        del p
        correct = torch.gather(logits, -1, labels[..., None])[..., 0]
        lse = m.float() + torch.log(sumexp)
        ctx.save_for_backward(logits, labels, m, sumexp)
        return lse - correct.float()

    @staticmethod
    def backward(ctx, g):
        logits, labels, m, sumexp = ctx.saved_tensors
        dt = logits.dtype
        # softmax in the model dtype: the single (..., V) backward buffer
        grad = torch.exp(logits - m[..., None]) / sumexp[..., None].to(dt)
        grad *= g[..., None].to(dt)
        # subtract g at the label (a scatter, no one-hot buffer)
        idx = labels[..., None]
        grad.scatter_(-1, idx, torch.gather(grad, -1, idx) - g[..., None].to(dt))
        return grad, None


def cross_entropy(logits, labels, cfg: ModelConfig):
    """logits: (B, S, V) or (B, S, cb, V) in the model dtype; labels: (B, S)
    or (B, S, cb) int, -1 = padding.  Mean NLL over the real labels."""
    if logits.dim() == 3:
        logits = logits[:, :, None, :]
        labels = labels[:, :, None]
    labels = labels.long()
    # each (batch, position) row on its own: under a mesh each chip takes
    # its own rows (the vocab is whole on every chip)
    nll = by_rows(lambda rows, _: NLL.apply(*rows), [logits, labels.clamp_min(0)], [])
    mask = (labels >= 0).float()
    return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)


def model_inputs(batch: Dict, cfg: ModelConfig) -> Dict:
    """``apply_model`` keyword arguments of a batch."""
    kwargs = {}
    if cfg.input_mode == "token":
        kwargs["tokens"] = batch["tokens"]
    else:
        kwargs["embeds"] = batch["embeds"]
    if cfg.num_image_tokens:
        kwargs["img_embeds"] = batch["img_embeds"]
    return kwargs


def loss_fn(params, batch: Dict, cfg: ModelConfig, *, backend: str = "kernel",
            seed: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    """The reference's loss: cross-entropy, plus ``load_balance_loss_weight
    * moe_lb_loss + 1e-3 * moe_z_loss`` for an MoE model.  Returns (loss,
    metrics).  ``seed``: the step's dropout seed (the reference's ``rng``);
    dropout runs when it is given and ``cfg.dropout_rate > 0``."""
    aux: Dict = {}
    logits, _ = apply_model(params, cfg, mode="train", backend=backend, aux=aux,
                            generator=None if seed is None else DropoutStream(seed),
                            deterministic=cfg.dropout_rate == 0.0,
                            **model_inputs(batch, cfg))
    ce = cross_entropy(logits, batch["labels"].to(logits.device), cfg)
    loss = ce
    if cfg.is_moe:
        loss = loss + cfg.load_balance_loss_weight * aux["moe_lb_loss"] + 1e-3 * aux["moe_z_loss"]
    return loss, {"ce_loss": ce, **{k: aux[k] for k in AUX_KEYS}}


def _detach(metrics: Dict) -> Dict:
    return {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in metrics.items()}


def make_train_step(cfg: ModelConfig, opt: AdamW, rules: Optional[Rules] = None, *,
                    backend: str = "kernel"):
    """Returns ``train_step(params, opt_state, batch, seed=None) ->
    (params, opt_state, metrics)``.  ``params`` is updated in place (and
    returned); the metrics are device scalars (``loss``, ``ce_loss``, the
    MoE aux values, ``grad_norm``) and the host float ``lr``.  ``batch``
    holds tensors on the params' device (or numpy arrays).  ``seed`` is
    the step's dropout seed, as the reference's ``rng`` (``launch/train.py``
    passes the step number, as the reference passes ``PRNGKey(step)``).
    ``rules`` are active inside the step."""

    def train_step(params, opt_state, batch, seed: Optional[int] = None):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            with axis_rules(rules):
                loss, metrics = loss_fn(params, batch, cfg, backend=backend, seed=seed)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        with axis_rules(rules):
            params, opt_state, opt_metrics = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss.detach(), **_detach(metrics), **opt_metrics}

    return train_step


def make_eval_step(cfg: ModelConfig, rules: Optional[Rules] = None, *,
                   backend: str = "kernel"):
    def eval_step(params, batch):
        with torch.no_grad(), axis_rules(rules):
            loss, metrics = loss_fn(params, batch, cfg, backend=backend)
        return {"loss": loss, **metrics}

    return eval_step


def batch_to_device(batch: Dict, device: Optional[torch.device]) -> Dict:
    """A numpy batch of the data pipeline as tensors on ``device``: int
    ids as int64, embeddings as fp32 (``apply_model`` casts them)."""
    return {k: torch.from_numpy(v).to(device=device,
                                      dtype=torch.long if v.dtype.kind in "iu" else None)
            for k, v in batch.items()}
