"""AdamW and the cosine schedule (counterpart of
``src/repro/training/optimizer.py``).

The state is an ``AdamWState`` of a step count and fp32 moments
congruent with the parameter tree, whatever the parameters' dtype (the
mixed-precision discipline of the reference).  :meth:`AdamW.update`
updates the parameters in place with the reference's per-leaf formula
(global-norm clip, bias-corrected moments, decoupled weight decay), as
``torch._foreach_*`` ops over runs of leaves (``CHUNK_ELEMENTS`` at a
time), so a step issues a few launches per operation rather than one
per leaf, and its fp32 temporaries stay within a run's size rather than
the model's.  The clip scale stays on the device: a step never waits
for the gradient norm.

Parameters laid over a mesh (``DTensor``s, as the dry run lays them) are
updated on each chip's shards: the gradients are first laid out as their
parameters (the data-parallel reduction), the clip norm is global, and
the per-element update runs on the local tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple

import numpy as np
import torch

from repro_torch.models.params import _leaves, _set


#: elements of the leaves one fused update covers (its fp32 temporaries:
#: 3 x 4 bytes an element, 4 x for low-precision params)
CHUNK_ELEMENTS = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-dim int32 on the host: the steps taken
    mu: Dict
    nu: Dict


def tree_leaves(tree: Dict) -> List[torch.Tensor]:
    """The leaves of a nested dict of tensors, in insertion order."""
    return [leaf for _, leaf in _leaves(tree)]


def tree_zeros(tree: Dict, dtype=torch.float32) -> Dict:
    out: Dict = {}
    for path, leaf in _leaves(tree):
        _set(out, path, torch.zeros(leaf.shape, dtype=dtype, device=leaf.device))
    return out


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Callable[[int], float]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0

    def init(self, params: Dict) -> AdamWState:
        return AdamWState(torch.zeros((), dtype=torch.int32), tree_zeros(params),
                          tree_zeros(params))

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: AdamWState, params: Dict):
        """One step: ``grads`` in the order of ``tree_leaves(params)`` (fp32
        gradients are scaled in place: the step consumes them).  Updates
        ``params`` and the moments in place and returns (params, new state,
        {"grad_norm": device scalar, "lr": float})."""
        ps = tree_leaves(params)
        mus, nus = tree_leaves(state.mu), tree_leaves(state.nu)
        sharded = hasattr(ps[0], "device_mesh")
        if sharded:
            grads = [g.redistribute(p.device_mesh, p.placements) for g, p in zip(grads, ps)]
        step = int(state.step) + 1
        f32 = np.float32
        lr = float(self.learning_rate(step))
        # bias corrections in fp32, as the reference computes them
        c1 = float(f32(1.0) - f32(self.b1) ** f32(step))
        c2 = float(f32(1.0) - f32(self.b2) ** f32(step))
        norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
        gnorm = torch.linalg.vector_norm(torch.stack(norms))
        scale = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
        if sharded:
            # the update is per element: each chip updates its own shards
            ps, grads, mus, nus = ([t.to_local() for t in ts] for ts in (ps, grads, mus, nus))
            scale = scale.full_tensor()
        for idx in _chunks(ps, CHUNK_ELEMENTS):
            self._update_chunk([ps[i] for i in idx], [grads[i] for i in idx],
                               [mus[i] for i in idx], [nus[i] for i in idx],
                               scale, lr, c1, c2)
        new_state = AdamWState(torch.tensor(step, dtype=torch.int32), state.mu, state.nu)
        return params, new_state, {"grad_norm": gnorm, "lr": lr}

    def _update_chunk(self, ps, grads, mus, nus, scale, lr, c1, c2):
        """The reference's per-leaf update on a few leaves at once: its fp32
        temporaries (the scaled gradient, the denominator, the step, the
        fp32 view of low-precision params) last for this chunk only."""
        g32 = [g if g.dtype == torch.float32 else g.float() for g in grads]
        torch._foreach_mul_(g32, scale)
        torch._foreach_mul_(mus, self.b1)
        torch._foreach_add_(mus, g32, alpha=1 - self.b1)
        torch._foreach_mul_(nus, self.b2)
        torch._foreach_addcmul_(nus, g32, g32, value=1 - self.b2)
        denom = g32  # the gradient is spent: its buffers take the denominator
        torch._foreach_copy_(denom, nus)
        torch._foreach_div_(denom, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        delta = torch._foreach_div(mus, c1)
        torch._foreach_div_(delta, denom)
        p32 = [p if p.dtype == torch.float32 else p.float() for p in ps]
        torch._foreach_add_(delta, p32, alpha=self.weight_decay)
        torch._foreach_add_(p32, delta, alpha=-lr)
        low = [(p, q) for p, q in zip(ps, p32) if p is not q]
        if low:
            torch._foreach_copy_([p for p, _ in low], [q for _, q in low])


def _chunks(leaves: List[torch.Tensor], limit: int) -> List[List[int]]:
    """Indices of ``leaves`` in consecutive runs of at most ``limit``
    elements (a larger leaf runs alone)."""
    out, run, n = [], [], 0
    for i, t in enumerate(leaves):
        if run and n + t.numel() > limit:
            out.append(run)
            run, n = [], 0
        run.append(i)
        n += t.numel()
    if run:
        out.append(run)
    return out


def cosine_schedule(peak: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine down
    to ``floor * peak`` at ``total``; computed in fp32 as the reference."""
    f32 = np.float32

    def fn(step: int) -> float:
        step = f32(step)
        warm = f32(peak) * step / f32(max(warmup, 1))
        frac = np.clip((step - f32(warmup)) / f32(max(total - warmup, 1)), f32(0), f32(1))
        cos = (f32(floor * peak) + f32((1 - floor) * peak) * f32(0.5)
               * (f32(1) + np.cos(f32(np.pi) * frac)))
        return float(warm if step < warmup else cos)

    return fn
