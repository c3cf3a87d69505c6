"""Checkpointing: params and optimizer state to ``.npz`` with a JSON
manifest (counterpart of ``src/repro/training/checkpoint.py``).

The files and key names are the reference's: ``params.npz`` holds every
leaf under its ``/``-joined path (``groups/b0_attn/wq``), ``opt_state.npz``
the ``AdamWState`` fields under the names JAX gives a NamedTuple's fields
(``.step``, ``.mu/<path>``, ``.nu/<path>``), and ``manifest.json`` the step
and any metadata.  So a checkpoint that either package wrote restores in
the other (fp32 leaves; numpy has no bfloat16 of its own, so the port
writes a bf16 leaf as fp32, which is exact, and casts every leaf to the
template leaf's dtype on restore).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models.params import _leaves, _set
from repro_torch.training.optimizer import AdamWState

_OPT_FIELDS = AdamWState._fields


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    return {prefix + "/".join(path): _to_numpy(leaf) for path, leaf in _leaves(tree)}


def _flatten_opt(state: AdamWState) -> Dict[str, np.ndarray]:
    flat = {".step": _to_numpy(state.step)}
    for field in ("mu", "nu"):
        flat.update(_flatten(getattr(state, field), f".{field}/"))
    return flat


def _unflatten_into(template: Dict, flat: Dict[str, np.ndarray], prefix: str = "") -> Dict:
    """A tree shaped as ``template``: each leaf from ``flat`` in the
    template leaf's dtype and on its device."""
    out: Dict = {}
    for path, leaf in _leaves(template):
        arr = np.asarray(flat[prefix + "/".join(path)])
        _set(out, path, torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype))
    return out


def save_checkpoint(path: str, step: int, params: Dict,
                    opt_state: Optional[AdamWState] = None,
                    meta: Optional[Dict[str, Any]] = None) -> None:
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "params.npz"), **_flatten(params))
    if opt_state is not None:
        np.savez(os.path.join(path, "opt_state.npz"), **_flatten_opt(opt_state))
    manifest = {"step": int(step), **(meta or {})}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)


def restore_checkpoint(path: str, params_template: Dict,
                       opt_template: Optional[AdamWState] = None):
    """Returns (manifest, params, opt_state or None): new tensors shaped,
    typed and placed as the templates."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "params.npz")) as z:
        params = _unflatten_into(params_template, dict(z))
    opt_state = None
    if opt_template is not None and os.path.exists(os.path.join(path, "opt_state.npz")):
        with np.load(os.path.join(path, "opt_state.npz")) as z:
            flat = dict(z)
        opt_state = AdamWState(
            torch.from_numpy(np.asarray(flat[".step"])).to(opt_template.step.dtype),
            _unflatten_into(opt_template.mu, flat, ".mu/"),
            _unflatten_into(opt_template.nu, flat, ".nu/"))
    return manifest, params, opt_state
