"""Fused connective block: dropout -> residual add -> layernorm, one pass.

The paper puts the connective blocks on the sequence axis because these
element-wise ops are memory-bandwidth bound (§III-B-3).  The fused kernel
reads x, the residual (and the keep-mask when dropout is on) once and
writes the output once: ``(x * keep / (1 - rate) if rate > 0) + res``,
then LayerNorm in fp32 (eps 1e-5), then ``* scale + bias``.  Dropout takes
a caller-supplied keep-mask so the kernel is deterministic.

It replaces the TPU kernel
``src/repro/kernels/fused_connective.py:fused_connective``.  On a CUDA
tensor :func:`fused_connective` launches the Triton kernel of
``csrc/fused_connective.py`` (one program per row); on a CPU tensor it
runs :func:`fused_connective_plain`.  The reference's ``block_s`` tiling
is a Pallas artefact and is gone: any row count runs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def fused_connective_plain(x, res, keep_mask, scale, bias, *, rate: float = 0.0,
                           eps: float = 1e-5):
    """Plain PyTorch version of :func:`fused_connective` (fp32 math)."""
    xf = x.float()
    if rate > 0:
        xf = xf * keep_mask.float() / (1.0 - rate)
    y = xf + res.float()
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    out = (y - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return out.to(x.dtype)


def fused_connective(x, res, keep_mask, scale, bias, *, rate: float = 0.0,
                     eps: float = 1e-5):
    """x, res: (S, d); keep_mask: (S, d) 0/1 (read only when ``rate > 0``,
    may be None otherwise); scale, bias: (d,).  Returns (S, d) in x.dtype."""
    if x.dim() != 2 or res.shape != x.shape:
        raise ValueError(f"x {tuple(x.shape)} and res {tuple(res.shape)} "
                         "must be the same (S, d)")
    s, d = x.shape
    if scale.shape != (d,) or bias.shape != (d,):
        raise ValueError(f"scale/bias must be ({d},)")
    if rate > 0 and (keep_mask is None or keep_mask.shape != x.shape):
        raise ValueError("rate > 0 needs a keep_mask of x's shape")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"rate must lie in [0, 1), got {rate}")
    if x.device.type == "cpu":
        return fused_connective_plain(x, res, keep_mask, scale, bias,
                                      rate=rate, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"no fused_connective kernel for {x.device}")
    x, res = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, res))
    scale, bias = scale.contiguous(), bias.contiguous()
    has_keep = rate > 0
    keep = keep_mask if has_keep else x
    if keep.stride(-1) != 1:
        keep = keep.contiguous()
    out = torch.empty((s, d), dtype=x.dtype, device=x.device)
    if s:
        block_d = 1 << (d - 1).bit_length()
        kernel = build.load_python("fused_connective").connective_kernel
        kernel[(s,)](
            x, res, keep, scale, bias, out, d, x.stride(0), res.stride(0),
            keep.stride(0), out.stride(0),
            1.0 / (1.0 - rate) if has_keep else 1.0, eps,
            HAS_KEEP=has_keep, BLOCK_D=block_d,
            num_warps=4 if block_d <= 2048 else 8,
        )
        fused_connective.launches += 1
    return out


fused_connective.launches = 0
