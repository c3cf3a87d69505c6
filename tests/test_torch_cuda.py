"""The hand-written kernels against their plain PyTorch versions on the card.

Marked ``cuda``: every test skips without a CUDA device (decided inside the
fixture, never at import).  Run on a GPU host with

  PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

This file imports no JAX (the GPU host has none); the plain versions are
held against the reference package by the CPU tests.

Tolerances: float32 1e-4 (fp32 FMA chains of up to K=1920 products summed
in another order than PyTorch's), float16 and bfloat16 1e-2 absolute on
O(1) outputs (both sides accumulate in fp32; the gap is the final
rounding and the order of the fp32 sums).  Pad outputs must be exactly
zero.
"""
import dataclasses
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.execplan import SeqLayout  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_plain,
    ragged_flash_attention,
    ragged_flash_attention_plain,
)
from repro_torch.kernels.fused_connective import (  # noqa: E402
    fused_connective,
    fused_connective_plain,
)
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_plain  # noqa: E402
from repro_torch.kernels.tiled_gemm import (  # noqa: E402
    dense_block_count,
    tiled_gemm_valid,
    tiled_gemm_valid_plain,
)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.float16: dict(atol=1e-2, rtol=1e-2),
       torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}
DTYPES = [torch.float32, torch.float16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _garbage_gemm(m, n, k, vm, vn, vk, seg_m, seg_n, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=device)
    w = torch.randn(k, n, generator=g, device=device) / k ** 0.5
    rows = (torch.arange(m, device=device) % seg_m) < vm
    cols = (torch.arange(n, device=device) % seg_n) < vn
    kk = torch.arange(k, device=device) < vk
    junk = 1e3
    x = torch.where(rows[:, None] & kk[None, :], x, junk)
    w = torch.where(kk[:, None] & cols[None, :], w, -junk)
    return x.to(dtype), w.to(dtype), rows, cols


# (m, n, k, valid_m, valid_n, valid_k, seg_m, seg_n): GPT2-L ring-tile and
# decode shapes, plus ragged edges, dead tiles and an empty contraction
GEMM_CASES = [
    (57, 1536, 1280, 56, 320, 1280, 57, 512),
    (57, 1280, 512, 31, 1280, 320, 57, 1280),
    (57, 1920, 1280, 57, 640, 1280, 57, 1920),
    (57, 1280, 1920, 57, 1280, 1280, 57, 1280),
    (4, 1536, 1280, 4, 128, 1280, 4, 512),
    (228, 100, 70, 40, 33, 65, 57, 50),
    (130, 70, 33, 0, 70, 33, 65, 70),
    (16, 16, 16, 16, 16, 0, 16, 16),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", GEMM_CASES)
def test_valid_gemm_kernel_matches_plain(cuda, case, dtype):
    m, n, k, vm, vn, vk, seg_m, seg_n = case
    x, w, rows, cols = _garbage_gemm(*case, dtype, cuda, seed=m + n + k)
    kw = dict(valid_m=vm, valid_n=vn, valid_k=vk, seg_m=seg_m, seg_n=seg_n)
    before = tiled_gemm_valid.launches
    out, cnt = tiled_gemm_valid(x, w, count_blocks=True, **kw)
    torch.cuda.synchronize()
    assert tiled_gemm_valid.launches == before + 1
    plain = tiled_gemm_valid_plain(x, w, **kw)
    torch.testing.assert_close(out.float(), plain.float(), **TOL[dtype])
    assert not out[~rows].any() and not out[:, ~cols].any()
    assert int(cnt) == dense_block_count(m, n, k, **kw)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [
    ((57, 56, 56, 31), 8, 8, 5, 64),   # a GPT2-L device shard
    ((5, 3, 0, 6), 4, 4, 3, 8),
    ((70, 1, 65, 0), 4, 2, 4, 32),     # GQA g=2, blocks past 64 rows
    ((40, 40), 2, 2, 1, 128),
    ((33, 20, 7), 3, 3, 3, 40),
])
def test_ragged_flash_kernel_matches_plain(cuda, case, dtype):
    tiles, h, hkv, vh, hd = case
    lay = SeqLayout(tiles)
    s = lay.padded_len
    g = torch.Generator(device=cuda).manual_seed(s + hd)
    # the executor's (B, S, H, hd) fused-QKV views, transposed: strided input
    qkv = torch.randn(2, s, h + 2 * hkv, hd, generator=g, device=cuda)
    pad = torch.as_tensor(~lay.valid, device=cuda)
    qkv[:, pad] = 1e3
    qkv[:, :, vh:h] = -1e3
    qkv = qkv.to(dtype)
    q, k, v = qkv.split([h, hkv, hkv], dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    out = ragged_flash_attention(q, k, v, positions=lay.positions, valid_heads=vh)
    torch.cuda.synchronize()
    plain = ragged_flash_attention_plain(q, k, v, positions=lay.positions,
                                         valid_heads=vh)
    assert not out[:, :, pad].any() and not out[:, vh:].any()
    torch.testing.assert_close(out.float(), plain.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("s,d", [(57, 1280), (100, 8), (3, 5000)])
def test_fused_connective_kernel_matches_plain(cuda, s, d, rate, dtype):
    g = torch.Generator(device=cuda).manual_seed(s * d)
    x, res = (torch.randn(s, d, generator=g, device=cuda).to(dtype) for _ in range(2))
    keep = (torch.rand(s, d, generator=g, device=cuda) > rate).to(dtype)
    scale = (1 + 0.1 * torch.randn(d, generator=g, device=cuda)).to(dtype)
    bias = (0.1 * torch.randn(d, generator=g, device=cuda)).to(dtype)
    out = fused_connective(x, res, keep, scale, bias, rate=rate)
    torch.cuda.synchronize()
    plain = fused_connective_plain(x, res, keep, scale, bias, rate=rate)
    torch.testing.assert_close(out.float(), plain.float(), **TOL[dtype])


def test_ops_kernel_backend_matches_eager(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(2, 57, 1280, generator=g, device=cuda)
    w = torch.randn(1280, 1536, generator=g, device=cuda) / 1280 ** 0.5
    kw = dict(valid_m=40, valid_n=320, seg_n=512)
    torch.testing.assert_close(ops.gemm(x, w, backend="kernel", **kw),
                               ops.gemm(x, w, backend="eager", **kw),
                               **TOL[torch.float32])
    with pytest.raises(ValueError, match="float32/float16"):
        tiled_gemm_valid(x[0].double(), w.double())


# (b, h, hkv, sq, sk, hd, causal, window): RecurrentGemma-9B's served
# prefill (MQA, hd 256, window 2048 < S 2100), then non-dividing lengths,
# GQA, queries right-aligned to longer keys, hd below its template width,
# no mask, window without causality, and one query row
FLASH_CASES = [
    (2, 16, 1, 2100, 2100, 256, True, 2048),
    (1, 4, 2, 130, 130, 64, True, 0),
    (2, 4, 1, 77, 200, 96, True, 50),
    (1, 2, 2, 65, 65, 32, False, 0),
    (1, 2, 1, 100, 100, 256, False, 17),
    (1, 3, 3, 1, 40, 128, True, 8),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, case, dtype):
    b, h, hkv, sq, sk, hd, causal, window = case
    g = torch.Generator(device=cuda).manual_seed(sq + sk + hd)
    # the zoo's (B, S, H, hd) projections, transposed: strided input
    q = torch.randn(b, sq, h, hd, generator=g, device=cuda).to(dtype).transpose(1, 2)
    k, v = (torch.randn(b, sk, hkv, hd, generator=g, device=cuda).to(dtype).transpose(1, 2)
            for _ in range(2))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    plain = flash_attention_plain(q, k, v, causal=causal, window=window)
    assert out.dtype == dtype and out.shape == (b, h, sq, hd)
    torch.testing.assert_close(out.float(), plain.float(), **TOL[dtype])


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.randn(1, 2, 8, 300, device=cuda)
    with pytest.raises(ValueError, match="head_dim 300"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="float32/bfloat16/float16"):
        flash_attention(q[..., :8].double(), q[..., :8].double(), q[..., :8].double())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,w", [(2, 2100, 4096), (3, 37, 50), (1, 1, 7), (2, 9, 129)])
def test_rglru_scan_kernel_matches_plain(cuda, b, s, w, dtype):
    g = torch.Generator(device=cuda).manual_seed(s + w)
    a = (0.5 + 0.499 * torch.rand(b, s, w, generator=g, device=cuda)).to(dtype)
    bb = torch.randn(b, s, w, generator=g, device=cuda).to(dtype)
    h0 = torch.randn(b, w, generator=g, device=cuda)  # nonzero carry
    before = rglru_scan.launches
    hs, hl = rglru_scan(a, bb, h0)
    torch.cuda.synchronize()
    assert rglru_scan.launches == before + 1
    ps, pl = rglru_scan_plain(a, bb, h0)
    assert hs.dtype == hl.dtype == dtype
    torch.testing.assert_close(hs.float(), ps.float(), **TOL[dtype])
    torch.testing.assert_close(hl.float(), pl.float(), **TOL[dtype])


def test_zoo_kernel_path_matches_eager_path(cuda):
    """Reduced 5-layer RecurrentGemma in fp32 on the card: prefill of 40
    tokens (window 32) and 4 decode steps, kernel vs eager backend; the
    prefill launches one flash attention and four scans, decode neither."""
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import TransformerExecutor

    cfg = dataclasses.replace(reduced(get_config("recurrentgemma-9b")), num_layers=5)
    params = init_params(cfg, generator=torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    kern = TransformerExecutor(params, cfg, backend="kernel")
    eager = TransformerExecutor(params, cfg, backend="eager")
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    ops.reset_launch_counts()
    lk, ck = kern.prefill(tokens, kern.make_cache(2, 48))
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1 and counts["rglru_scan"] == 4
    le, ce = eager.prefill(tokens, eager.make_cache(2, 48))
    torch.testing.assert_close(lk, le, **TOL[torch.float32])
    for step in range(4):
        tok = le.argmax(-1)[:, None]
        lk, ck = kern.decode(tok, ck, 40 + step)
        le, ce = eager.decode(tok, ce, 40 + step)
        torch.testing.assert_close(lk, le, **TOL[torch.float32])
    assert ops.launch_counts() == counts
