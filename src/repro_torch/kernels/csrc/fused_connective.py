"""Fused connective block in Triton: dropout -> residual add -> layernorm.

Replaces the TPU kernel src/repro/kernels/fused_connective.py:
fused_connective (body _kernel).  One program per row holds the whole
d-wide row in one masked block (BLOCK_D = next power of two >= d): it
reads x, the residual (and the keep-mask when dropout is on) once,
computes ``(x * keep / (1 - rate) if rate > 0) + res``, LayerNorm in fp32
(eps 1e-5), ``* scale + bias``, and writes the row once.

What bounds it on the H100: bytes.  A GPT2-L device tile is ~57 x 1280
rows in fp16, ~0.4 MB in and 0.15 MB out against ~0.6 MFLOP.  The design
moves the least it can — each input read once, every intermediate kept in
registers — and needs no tensor-core work, which is why Triton serves as
well as CUDA C++ here.

This file imports ``triton`` at its top, so it is not part of the package:
``kernels/build.py:load_python`` loads it at the first launch, on a host
that has Triton.
"""
import triton
import triton.language as tl


@triton.jit
def connective_kernel(x_ptr, res_ptr, keep_ptr, scale_ptr, bias_ptr, out_ptr,
                      d, stride_x, stride_r, stride_k, stride_o, keep_scale,
                      eps, HAS_KEEP: tl.constexpr, BLOCK_D: tl.constexpr):
    row = tl.program_id(0)
    cols = tl.arange(0, BLOCK_D)
    m = cols < d
    x = tl.load(x_ptr + row * stride_x + cols, mask=m, other=0.0).to(tl.float32)
    if HAS_KEEP:
        keep = tl.load(keep_ptr + row * stride_k + cols, mask=m, other=0.0)
        x = x * keep.to(tl.float32) * keep_scale
    y = x + tl.load(res_ptr + row * stride_r + cols, mask=m, other=0.0).to(tl.float32)
    mu = tl.sum(y, axis=0) / d
    diff = tl.where(m, y - mu, 0.0)
    var = tl.sum(diff * diff, axis=0) / d
    out = diff * tl.rsqrt(var + eps)
    scale = tl.load(scale_ptr + cols, mask=m, other=0.0).to(tl.float32)
    bias = tl.load(bias_ptr + cols, mask=m, other=0.0).to(tl.float32)
    out = out * scale + bias
    tl.store(out_ptr + row * stride_o + cols,
             out.to(out_ptr.dtype.element_ty), mask=m)
