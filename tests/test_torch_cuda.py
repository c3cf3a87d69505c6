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
    MAX_SHARDS,
    fused_connective,
    fused_connective_group,
    fused_connective_group_plain,
    fused_connective_plain,
)
from repro_torch.kernels.rglru_scan import (  # noqa: E402
    plan_scan,
    rglru_scan,
    rglru_scan_plain,
)
from repro_torch.kernels.tiled_gemm import (  # noqa: E402
    dense_block_count,
    tiled_gemm,
    tiled_gemm_plain,
    tiled_gemm_valid,
    tiled_gemm_valid_plain,
)
from repro_torch.serving.graphs import leaves, stats_since  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.float16: dict(atol=1e-2, rtol=1e-2),
       torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}
DTYPES = [torch.float32, torch.float16]
# the kernels with a bf16 path besides fp16 (the Galaxy path serves bf16)
DTYPES3 = DTYPES + [torch.bfloat16]


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
    # split-K: odd valid_n and valid_k, so a 16-byte chunk straddles each
    # edge and valid_k ends inside a slice
    (57, 1536, 1280, 56, 317, 1061, 57, 512),
    # the served decode: one-row segments (4 slots, then many), packed
    (4, 1536, 1280, 1, 320, 1280, 1, 512),
    (4, 1280, 1920, 1, 1280, 1280, 1, 1280),
    (33, 1280, 1920, 1, 1237, 1237, 1, 1280),
    (192, 200, 77, 1, 37, 37, 1, 100),
    # segments of 30 rows packed two to a tile, odd row strides
    (90, 40, 301, 7, 33, 257, 30, 40),
    # the Galaxy chunk and verify tiles on the 3:2:2:1 plan: a 128-row chunk
    # (36-row tiles, the straggler's 20 real rows), the 5-row verify chunk
    # (2-row tiles of 2 or 1 real rows) and shorter ones (1-row tiles of 1
    # or 0 real rows: a device with no rows of the chunk)
    (36, 1536, 1280, 20, 320, 1280, 36, 512),
    (36, 1280, 1920, 36, 1280, 1280, 36, 1280),
    (2, 1536, 1280, 2, 640, 1280, 2, 512),
    (2, 1536, 1280, 1, 128, 1280, 2, 512),
    (2, 1280, 512, 1, 1280, 320, 2, 1280),
    (2, 1920, 1280, 0, 1280, 1280, 2, 1920),
    (1, 1280, 1920, 0, 1280, 640, 1, 1280),
    (1, 1536, 1280, 1, 320, 1280, 1, 512),
    (1, 1920, 1280, 1, 1920, 1280, 1, 1920),
    # the one-device DistilBERT draft (d 768, 12 heads, d_ff 3072): a
    # prefill and a 4-slot decode step
    (304, 2304, 768, 304, 768, 768, 304, 768),
    (304, 768, 3072, 304, 768, 3072, 304, 768),
    (4, 3072, 768, 1, 3072, 768, 1, 3072),
    (4, 768, 768, 1, 768, 768, 1, 768),
    # Megatron's replicated full sequence (256 rows, no row padding)
    (256, 1536, 1280, 256, 320, 1280, 256, 512),
]


@pytest.mark.parametrize("dtype", DTYPES3)
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


# (tiles, heads, kv heads, valid heads, head dim)
RAGGED_CASES = [
    ((57, 56, 56, 31), 8, 8, 5, 64),   # a GPT2-L device shard
    ((5, 3, 0, 6), 4, 4, 3, 8),
    ((70, 1, 65, 0), 4, 2, 4, 32),     # GQA g=2, blocks past 64 rows
    ((40, 40), 2, 2, 1, 128),
    ((33, 20, 7), 3, 3, 3, 40),
]


@pytest.mark.parametrize("dtype", DTYPES3)
@pytest.mark.parametrize("case", RAGGED_CASES)
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


@pytest.mark.parametrize("dtype", DTYPES3)
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


# (m, n, k, valid_m, valid_n, valid_k, seg_m, seg_n): split over several
# slices, one slice, packed decode
SPLIT_CASES = [GEMM_CASES[0], GEMM_CASES[8], GEMM_CASES[9], GEMM_CASES[11]]


@pytest.mark.parametrize("dtype", DTYPES3)
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_valid_gemm_is_bitwise_repeatable_and_counts_its_path(cuda, case, dtype):
    """The split-K slices meet in a fixed order: the same call gives the
    same bits; fp16 and bf16 take the tensor-core path, fp32 the CUDA
    cores."""
    m, n, k, vm, vn, vk, seg_m, seg_n = case
    x, w, _, _ = _garbage_gemm(*case, dtype, cuda, seed=7)
    kw = dict(valid_m=vm, valid_n=vn, valid_k=vk, seg_m=seg_m, seg_n=seg_n)
    path = "fma" if dtype == torch.float32 else "mma"
    before = dict(tiled_gemm_valid.paths)
    a = tiled_gemm_valid(x, w, **kw)
    b = tiled_gemm_valid(x, w, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert tiled_gemm_valid.paths[path] == before[path] + 2
    assert sum(tiled_gemm_valid.paths.values()) == sum(before.values()) + 2


def test_valid_gemm_back_to_back_shapes_share_the_workspace(cuda):
    """Launches of different shapes queued without a sync reuse the
    workspace and the arrival counters; every result is right and every
    counter is back at 0."""
    from repro_torch.kernels import tiled_gemm as tg

    runs = []
    for i, case in enumerate(SPLIT_CASES * 2 + GEMM_CASES[:4]):
        dtype = DTYPES[i % 2]
        x, w, _, _ = _garbage_gemm(*case, dtype, cuda, seed=100 + i)
        m, n, k, vm, vn, vk, seg_m, seg_n = case
        kw = dict(valid_m=vm, valid_n=vn, valid_k=vk, seg_m=seg_m, seg_n=seg_n)
        runs.append((x, w, kw, tiled_gemm_valid(x, w, **kw)))
    torch.cuda.synchronize()
    for x, w, kw, out in runs:
        torch.testing.assert_close(out.float(), tiled_gemm_valid_plain(x, w, **kw).float(),
                                   **TOL[x.dtype])
        assert torch.equal(out, tiled_gemm_valid(x, w, **kw))
    _, counters = tg._workspaces[torch.cuda.current_device()]
    assert not counters.any()


def test_ops_kernel_backend_matches_eager(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(2, 57, 1280, generator=g, device=cuda)
    w = torch.randn(1280, 1536, generator=g, device=cuda) / 1280 ** 0.5
    kw = dict(valid_m=40, valid_n=320, seg_n=512)
    torch.testing.assert_close(ops.gemm(x, w, backend="kernel", **kw),
                               ops.gemm(x, w, backend="eager", **kw),
                               **TOL[torch.float32])
    with pytest.raises(ValueError, match="float32/float16/bfloat16"):
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
    # StableLM-12B's head dim 160 on GQA 4:1, a prefill chunk at an offset
    (1, 32, 8, 256, 1280, 160, True, 0),
    (1, 4, 1, 37, 300, 160, True, 0),
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


@pytest.mark.parametrize("dtype", DTYPES3)
@pytest.mark.parametrize("hd", [64, 160, 256])
def test_flash_kernel_refuses_a_plan_it_does_not_build(cuda, dtype, hd):
    """The C interface checks the key-block size and the grid the wrapper
    worked out: the planned call launches, a call off in either is
    refused before any launch."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    b, h, sq = 1, 2, 100
    q = torch.randn(b, h, sq, hd, device=cuda).to(dtype)
    out = torch.empty_like(q)
    path = fa.attention_path(dtype, hd)
    hdp = fa.head_dim_instance(hd, path)
    q_tiles = fa.attention_grid(b, h, sq, path)[0]
    bk = fa.attention_tiles(path, hdp)[1]
    lib = build.load("flash_attention", fa._DENSE_SIGNATURES)
    strides = [t.stride(i) for t in (q, q, q, out) for i in (0, 2, 1)]
    stream = torch.cuda.current_stream().cuda_stream

    def call(tiles, block_k):
        return lib.flash_attention(fa._DTYPES[dtype], hdp, tiles, block_k, q.data_ptr(),
                                   q.data_ptr(), q.data_ptr(), out.data_ptr(), None, b, h, h,
                                   sq, sq, hd, 1, 0, *strides, stream)

    assert call(q_tiles, bk) == 0
    torch.cuda.synchronize()
    for tiles, block_k in ((q_tiles, 2 * bk), (q_tiles, bk // 2), (q_tiles + 1, bk)):
        assert call(tiles, block_k) != 0


def _ragged_inputs(case, dtype, device, seed, junk=1e3):
    """The executor's fused-QKV (B, S, H + 2 Hkv, hd) tensor, transposed to
    (B, H, S, hd) views, with +junk in every pad row and -junk in every pad
    head slot of q, k and v."""
    tiles, h, hkv, vh, hd = case
    lay = SeqLayout(tiles)
    s = lay.padded_len
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(2, s, h + 2 * hkv, hd, generator=g, device=device)
    pad = torch.as_tensor(~lay.valid, device=device)
    qkv[:, pad] = junk
    qkv[:, :, vh:h] = -junk
    kv_pad = -(-vh // (h // hkv))  # kv heads that no valid q head reads
    qkv[:, :, h + kv_pad:h + hkv] = -junk
    qkv[:, :, h + hkv + kv_pad:] = -junk
    q, k, v = qkv.to(dtype).split([h, hkv, hkv], dim=2)
    return lay, pad, [t.transpose(1, 2) for t in (q, k, v)]


@pytest.mark.parametrize("dtype", DTYPES3)
@pytest.mark.parametrize("case", [c[:4] + (64,) for c in RAGGED_CASES])
def test_ragged_flash_kernel_zeroes_pad_rows_and_heads_at_hd64(cuda, case, dtype):
    """Every ragged case at the served head dim, with +-1e3 junk in every
    pad row and pad head slot of q, k and v: pad outputs exactly 0, valid
    rows equal to the plain version."""
    lay, pad, (q, k, v) = _ragged_inputs(case, dtype, cuda, seed=11)
    vh = case[3]
    out = ragged_flash_attention(q, k, v, positions=lay.positions, valid_heads=vh)
    torch.cuda.synchronize()
    assert not out[:, :, pad].any() and not out[:, vh:].any()
    plain = ragged_flash_attention_plain(q, k, v, positions=lay.positions, valid_heads=vh)
    torch.testing.assert_close(out.float(), plain.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES3)
def test_attention_kernels_are_bitwise_repeatable_and_count_their_path(cuda, dtype):
    """No atomics: a second call gives the same bits.  bf16/fp16 take the
    tensor-core path ("mma"), fp32 the CUDA cores ("simt"), one launch a
    call."""
    path = "simt" if dtype == torch.float32 else "mma"
    lay, _, (q, k, v) = _ragged_inputs(RAGGED_CASES[0], dtype, cuda, seed=12)
    before = dict(ragged_flash_attention.paths)
    a, b = (ragged_flash_attention(q, k, v, positions=lay.positions, valid_heads=5)
            for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert ragged_flash_attention.paths[path] == before[path] + 2
    assert sum(ragged_flash_attention.paths.values()) == sum(before.values()) + 2
    for case in (FLASH_CASES[1], FLASH_CASES[2], FLASH_CASES[6]):
        bb, h, hkv, sq, sk, hd, causal, window = case
        g = torch.Generator(device=cuda).manual_seed(sq)
        qd = torch.randn(bb, sq, h, hd, generator=g, device=cuda).to(dtype).transpose(1, 2)
        kd, vd = (torch.randn(bb, sk, hkv, hd, generator=g, device=cuda).to(dtype)
                  .transpose(1, 2) for _ in range(2))
        before = dict(flash_attention.paths)
        a, b = (flash_attention(qd, kd, vd, causal=causal, window=window) for _ in range(2))
        torch.cuda.synchronize()
        assert torch.equal(a, b)
        assert flash_attention.paths[path] == before[path] + 2
        assert sum(flash_attention.paths.values()) == sum(before.values()) + 2


@pytest.mark.parametrize("dtype", DTYPES3)
def test_attention_kernels_take_misaligned_rows(cuda, dtype):
    """Views whose rows start off a 16-byte boundary (odd row strides, a
    base one element in) are copied element by element: the same results
    as the plain version."""
    g = torch.Generator(device=cuda).manual_seed(13)
    b, h, hkv, sq, sk, hd = 1, 4, 2, 70, 100, 64

    def view(s, heads):  # (B, S, heads, hd + 1) sliced to hd from column 1
        return torch.randn(b, s, heads, hd + 1, generator=g, device=cuda).to(dtype)[
            ..., 1:].transpose(1, 2)

    q, k, v = view(sq, h), view(sk, hkv), view(sk, hkv)
    assert q.data_ptr() % 16  # every row starts off a 16-byte boundary
    out = flash_attention(q, k, v, causal=True, window=40)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), flash_attention_plain(
        q, k, v, causal=True, window=40).float(), **TOL[dtype])
    lay = SeqLayout((30, 25, 0, 28))
    s = lay.padded_len
    q, k, v = view(s, h), view(s, hkv), view(s, hkv)
    out = ragged_flash_attention(q, k, v, positions=lay.positions, valid_heads=3)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ragged_flash_attention_plain(
        q, k, v, positions=lay.positions, valid_heads=3).float(), **TOL[dtype])


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


def _connective_group(rows, d, rate, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(shape, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(shape, generator=g, device=device)).to(dtype)

    xs = [draw((r, d)) for r in rows]
    ress = [draw((r, d)) for r in rows]
    keeps = [(torch.rand(r, d, generator=g, device=device) > rate).to(dtype) for r in rows]
    scales = [draw(d, 0.1, 1.0) for _ in rows]
    biases = [draw(d, 0.1) for _ in rows]
    return xs, ress, keeps, scales, biases


def _assert_connective_close(out, ref, dtype):
    """TOL, and for bf16 ATOL plus one bf16 unit of the output: both sides
    round one fp32 result, and at outputs of 2-4 one bf16 unit (0.0156)
    exceeds ATOL."""
    assert out.dtype == ref.dtype and out.shape == ref.shape
    if dtype != torch.bfloat16:
        torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
        return
    lim = TOL[dtype]["atol"] + 2.0 ** -7 * ref.float().abs()
    assert bool(((out.float() - ref.float()).abs() <= lim).all())


# shard rows of one site: D = 1..5, unequal, with empty shards
GROUP_ROWS = [(57,), (31, 0), (57, 56, 31), (57, 56, 56, 31), (57, 56, 0, 31, 5)]


@pytest.mark.parametrize("dtype", DTYPES3)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("rows", GROUP_ROWS)
@pytest.mark.parametrize("d", [1280, 2560])  # GPT2-L, OPT-XL: both register instances
def test_connective_group_matches_plain_per_shard(cuda, d, rows, rate, dtype):
    """All the shards of a site in one launch on the register-row path,
    each shard equal to the plain version."""
    args = _connective_group(rows, d, rate, dtype, cuda, seed=sum(rows) + d)
    launches, before = fused_connective_group.launches, dict(fused_connective_group.paths)
    outs = fused_connective_group(*args, rate=rate)
    torch.cuda.synchronize()
    assert fused_connective_group.launches == launches + 1
    assert fused_connective_group.paths["warp"] == before["warp"] + 1
    for out, ref in zip(outs, fused_connective_group_plain(*args, rate=rate)):
        _assert_connective_close(out, ref, dtype)


# the connective sites of the chunk and verify paths: four shards of the
# padded tile (36, 2 or 1 rows, some holding no real row; the kernel does
# not know which), and the one-device draft's single shard at d 768
NEW_SITES = [((36, 36, 36, 36), 1280), ((2, 2, 2, 2), 1280), ((1, 1, 1, 1), 1280),
             ((304,), 768), ((1,), 768)]


@pytest.mark.parametrize("dtype", DTYPES3)
@pytest.mark.parametrize("rows,d", NEW_SITES)
def test_connective_group_at_chunk_verify_and_draft_sites(cuda, rows, d, dtype):
    args = _connective_group(rows, d, 0.0, dtype, cuda, seed=sum(rows) + d)
    launches = fused_connective_group.launches
    outs = fused_connective_group(*args, rate=0.0)
    torch.cuda.synchronize()
    assert fused_connective_group.launches == launches + 1
    for out, ref in zip(outs, fused_connective_group_plain(*args, rate=0.0)):
        _assert_connective_close(out, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES3)
def test_connective_group_splits_past_max_shards(cuda, dtype):
    rows = [7 * (i % 3) + 1 for i in range(MAX_SHARDS + 3)]
    args = _connective_group(rows, 768, 0.0, dtype, cuda, seed=3)
    launches = fused_connective_group.launches
    outs = fused_connective_group(*args)
    torch.cuda.synchronize()
    assert fused_connective_group.launches == launches + 2
    for out, ref in zip(outs, fused_connective_group_plain(*args)):
        _assert_connective_close(out, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES3)
def test_connective_group_takes_other_rows_on_the_loop_path(cuda, dtype):
    """Rows wider than the registers hold, a width off the 16-byte vector,
    and strided views off a 16-byte boundary take the loop path."""
    for d, offset in ((2568 if dtype != torch.float32 else 2564, 0), (1284 - 2, 0), (640, 1)):
        xs, ress, keeps, scales, biases = _connective_group((9, 4), d + offset, 0.1, dtype,
                                                            cuda, seed=d)
        xs, ress = [x[:, offset:] for x in xs], [r[:, offset:] for r in ress]
        keeps = [k[:, offset:] for k in keeps]
        scales, biases = [s[offset:] for s in scales], [b[offset:] for b in biases]
        before = dict(fused_connective_group.paths)
        outs = fused_connective_group(xs, ress, keeps, scales, biases, rate=0.1)
        torch.cuda.synchronize()
        assert fused_connective_group.paths["loop"] == before["loop"] + 1
        for out, ref in zip(outs, fused_connective_group_plain(xs, ress, keeps, scales,
                                                               biases, rate=0.1)):
            _assert_connective_close(out, ref, dtype)


# (b, s, w): both served waves, a strip cut by w, S shorter than a stage,
# and the odd widths (simt)
SCAN_CASES = [(4, 300, 4096), (2, 2100, 4096), (2, 40, 40), (3, 17, 256),
              (3, 37, 50), (1, 1, 7), (2, 9, 129)]


@pytest.mark.parametrize("dtype", DTYPES3)
@pytest.mark.parametrize("b,s,w", SCAN_CASES)
def test_rglru_scan_fp32_bitwise_and_counts_its_path(cuda, b, s, w, dtype):
    """fp32 bitwise equal to the plain version (both round each product and
    sum once, in the same order), 16-bit types at TOL; the TMA path where
    rows are 16-byte multiples, the simt path elsewhere."""
    g = torch.Generator(device=cuda).manual_seed(b * s + w)
    a = (0.5 + 0.499 * torch.rand(b, s, w, generator=g, device=cuda)).to(dtype)
    bb = torch.randn(b, s, w, generator=g, device=cuda).to(dtype)
    h0 = torch.randn(b, w, generator=g, device=cuda)
    esize = a.element_size()
    path = "tma" if (w * esize) % 16 == 0 else "simt"
    assert plan_scan(b, s, w, esize, 132).path == path
    before = dict(rglru_scan.paths)
    hs, hl = rglru_scan(a, bb, h0)
    torch.cuda.synchronize()
    assert rglru_scan.paths[path] == before[path] + 1
    ps, pl = rglru_scan_plain(a, bb, h0)
    if dtype == torch.float32:
        assert torch.equal(hs, ps) and torch.equal(hl, pl)
    else:
        torch.testing.assert_close(hs.float(), ps.float(), **TOL[dtype])
        torch.testing.assert_close(hl.float(), pl.float(), **TOL[dtype])


def test_rglru_scan_takes_misaligned_inputs_on_the_simt_path(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    b, s, w = 2, 70, 256
    a = (0.5 + 0.499 * torch.rand(b * s * w + 1, generator=g, device=cuda))[1:].view(b, s, w)
    bb = torch.randn(b, s, w, generator=g, device=cuda)
    h0 = torch.randn(b, w, generator=g, device=cuda)
    assert a.data_ptr() % 16
    before = dict(rglru_scan.paths)
    hs, hl = rglru_scan(a, bb, h0)
    torch.cuda.synchronize()
    assert rglru_scan.paths["simt"] == before["simt"] + 1
    ps, pl = rglru_scan_plain(a, bb, h0)
    assert torch.equal(hs, ps) and torch.equal(hl, pl)


@pytest.mark.parametrize("dtype", DTYPES3)
def test_scan_and_connective_are_bitwise_repeatable(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(6)
    a = (0.5 + 0.499 * torch.rand(2, 2100, 4096, generator=g, device=cuda)).to(dtype)
    bb = torch.randn(2, 2100, 4096, generator=g, device=cuda).to(dtype)
    h0 = torch.randn(2, 4096, generator=g, device=cuda)
    first, second = rglru_scan(a, bb, h0), rglru_scan(a, bb, h0)
    args = _connective_group((57, 56, 56, 31), 1280, 0.1, dtype, cuda, seed=7)
    one, two = (fused_connective_group(*args, rate=0.1) for _ in range(2))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    assert all(torch.equal(x, y) for x, y in zip(one, two))


def test_rglru_scan_refuses_a_plan_it_does_not_build(cuda):
    """The C interface checks the strip, rows, stages, grid and shared
    memory the wrapper worked out: the planned call launches, a call off
    in any of them is refused before any launch."""
    import dataclasses as dc

    from repro_torch.kernels import build
    from repro_torch.kernels import rglru_scan as scan

    b, s, w = 2, 100, 256
    a = torch.rand(b, s, w, device=cuda)
    h0 = torch.zeros(b, w, device=cuda)
    out, last = torch.empty_like(a), torch.empty(b, w, device=cuda)
    lib = build.load("rglru_scan", scan._SIGNATURES)
    stream = torch.cuda.current_stream().cuda_stream
    plan = plan_scan(b, s, w, 4, 132)

    def call(p):
        return lib.rglru_scan(0, scan._PATHS[p.path], a.data_ptr(), a.data_ptr(),
                              h0.data_ptr(), out.data_ptr(), last.data_ptr(), b, s, w,
                              p.strip, p.rows, p.stages, p.grid[0], p.smem_bytes, stream)

    assert call(plan) == 0
    torch.cuda.synchronize()
    for bad in (dc.replace(plan, strip=64), dc.replace(plan, rows=64),
                dc.replace(plan, stages=9, smem_bytes=9 * 8192 + 128),
                dc.replace(plan, smem_bytes=plan.smem_bytes + 16),
                dc.replace(plan, grid=(plan.grid[0] + 1, b)),
                dc.replace(plan_scan(b, s, w, 4, 132, aligned=False), strip=32)):
        assert call(bad) != 0


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


# (m, k, n): the reference's test sweep, then shapes no tile divides
DENSE_GEMM_CASES = [(128, 256, 128), (256, 512, 384), (512, 128, 256),
                    (201, 333, 157), (1, 7, 1), (130, 1, 129)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m,k,n", DENSE_GEMM_CASES)
def test_dense_gemm_kernel_matches_plain(cuda, m, k, n, dtype):
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    w = (torch.randn(k, n, generator=g, device=cuda) / k ** 0.5).to(dtype)
    # the reference's sweep tiles in 128-blocks; the rest take the default
    # blocks, each clipped to its axis
    blocks = ({"block_m": 128, "block_n": 128, "block_k": 128}
              if m % 128 == k % 128 == n % 128 == 0 else {})
    before = tiled_gemm.launches
    out = tiled_gemm(x, w, **blocks)
    torch.cuda.synchronize()
    assert tiled_gemm.launches == before + 1
    assert out.dtype == dtype and out.shape == (m, n)
    torch.testing.assert_close(out.float(), tiled_gemm_plain(x, w).float(), **TOL[dtype])
    # a strided operand is taken as it is
    wt = w.t().contiguous().t()
    torch.testing.assert_close(tiled_gemm(x, wt, **blocks).float(), out.float(),
                               **TOL[dtype])


# (m, k, n): aligned rows, so bf16/fp16 take the wgmma path, with ragged M,
# N and K edges (TMA zero-fills past them), and a tall-K case
WGMMA_CASES = [(200, 264, 136), (1, 8, 8), (130, 520, 1000), (384, 4096, 256)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("m,k,n", WGMMA_CASES + [(201, 333, 157)])
def test_dense_gemm_takes_the_path_its_operands_allow(cuda, m, k, n, dtype):
    """bf16/fp16 with 16-byte rows on the tensor cores (wgmma), fp32 and
    the odd 201 x 333 x 157 shape on the CUDA cores; each counted."""
    g = torch.Generator(device=cuda).manual_seed(m * k + n)
    x = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    w = (torch.randn(k, n, generator=g, device=cuda) / k ** 0.5).to(dtype)
    path = ("wgmma" if dtype != torch.float32 and (m, k, n) != (201, 333, 157)
            else "simt")
    before = dict(tiled_gemm.paths)
    out = tiled_gemm(x, w, block_m=m, block_n=n, block_k=k)  # blocks: whole axes
    torch.cuda.synchronize()
    assert tiled_gemm.paths[path] == before[path] + 1
    assert sum(tiled_gemm.paths.values()) == sum(before.values()) + 1
    ref = tiled_gemm_plain(x, w).float()
    # both sides sum in fp32; bf16/fp16 outputs may round one unit apart
    ulp = {torch.float32: 1e-5, torch.float16: 2.0 ** -10, torch.bfloat16: 2.0 ** -7}[dtype]
    lim = TOL[dtype]["atol"] + ulp * ref.abs()
    assert bool(((out.float() - ref).abs() <= lim).all())


def test_dense_gemm_wgmma_at_the_served_width(cuda):
    """StableLM-12B's MLP up-projection on a 512-row chunk, bf16: the
    wgmma path, within one bf16 unit of the fp32 product."""
    g = torch.Generator(device=cuda).manual_seed(0)
    m, k, n = 512, 5120, 13824
    x = torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn(k, n, generator=g, device=cuda) / k ** 0.5).to(torch.bfloat16)
    before = tiled_gemm.paths["wgmma"]
    out = ops.tiled_gemm(x, w)
    torch.cuda.synchronize()
    assert tiled_gemm.paths["wgmma"] == before + 1
    ref = tiled_gemm_plain(x, w).float()
    assert bool(((out.float() - ref).abs() <= 1e-2 + 2.0 ** -7 * ref.abs()).all())


def test_dense_gemm_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(100, 64, device=cuda)
    with pytest.raises(ValueError, match="block_m=48"):
        ops.tiled_gemm(x, torch.zeros(64, 96, device=cuda), block_m=48, block_n=32,
                       block_k=32)
    with pytest.raises(ValueError, match="contraction mismatch"):
        tiled_gemm(x, torch.zeros(48, 96, device=cuda))
    with pytest.raises(ValueError, match="float32/bfloat16/float16"):
        tiled_gemm(x.double(), torch.zeros(64, 96, device=cuda).double())


def test_dense_paged_protocol_kernel_matches_eager(cuda):
    """Reduced StableLM (GQA 4:2, head dim 64) in fp32 on the card: the
    paged protocol's one-shot prefill, chunks at offsets 16 and 32, and 4
    decode steps, kernel vs eager backend; 2 flash launches per prefill
    call, none in decode."""
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import TransformerExecutor

    cfg = dataclasses.replace(reduced(get_config("stablelm-12b")), num_kv_heads=2)
    params = init_params(cfg, generator=torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (1, 48), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    rows = [[1, 2, 3, 4], [5, 6, 7, 8]]
    out = {}
    for backend in ("kernel", "eager"):
        ex = TransformerExecutor(params, cfg, backend=backend)
        pool = ex.make_pool(9, 16)
        ops.reset_launch_counts()
        lo, pool = ex.prefill_paged(tokens[:, :32], pool, rows[0], length=30)
        chunks = []
        for off in (0, 16, 32):
            lc, pool = ex.prefill_chunk(tokens[:, off:off + 16], pool, rows[1],
                                        offset=off, length=48)
            chunks.append(lc)
        n_flash = ops.launch_counts()["flash_attention"]
        assert n_flash == (2 * 4 if backend == "kernel" else 0)
        decoded = []
        table = torch.tensor(rows, device=cuda)
        pos = torch.tensor([30, 48], device=cuda)
        tok = torch.stack([lo[0].argmax(), chunks[-1][0, -1].argmax()])
        for step in range(4):
            logits, pool = ex.decode_paged(tok[:, None], pool, table, pos + step)
            decoded.append(logits)
            tok = logits.argmax(-1)
        assert ops.launch_counts()["flash_attention"] == n_flash
        out[backend] = (lo, torch.cat(chunks, 1), torch.stack(decoded), pool)
    for got, want in zip(out["kernel"][:3], out["eager"][:3]):
        torch.testing.assert_close(got, want, **TOL[torch.float32])
    for key, leaves in out["kernel"][3]["groups"].items():
        for name, leaf in leaves.items():
            torch.testing.assert_close(leaf, out["eager"][3]["groups"][key][name],
                                       **TOL[torch.float32])


def test_host_profiler_times_the_card(cuda, monkeypatch):
    """``HostProfiler`` on the card: positive block times, each block's
    timed loop between two ``torch.cuda.synchronize()`` (after a warm-up
    call), and a positive capacity."""
    from repro_torch.core.profiler import HostProfiler

    syncs = []
    orig = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: (syncs.append(1), orig(*a, **k))[1])
    hp = HostProfiler(get_config("gpt2-l"), 256, iters=3)
    assert hp.device.type == "cuda"
    t = hp.measure_blocks(heads=8, columns=1920)
    assert set(t) == {"mha", "mlp", "con"} and all(v > 0 for v in t.values())
    assert len(syncs) == 2 * 3  # warm-up sync + end-of-loop sync, per block
    assert hp.capacity() > 0


def test_traced_galaxy_serve_tokens_equal_untraced(cuda):
    """A short traced Galaxy serve (tracer, drift, record_times) on the
    uneven 3:2:2:1 plan on the card, fp32 kernel backend: no open span,
    drift records of both kinds, tokens equal to the untraced serve."""
    from repro_torch.core import hmp
    from repro_torch.core.execplan import ExecPlan
    from repro_torch.core.ring import LocalRing
    from repro_torch.obs import DriftMonitor, Tracer
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.galaxy import GalaxyHMPExecutor

    plan = ExecPlan(heads=(6, 4, 4, 2), columns=(24, 16, 16, 8), head_dim=2, d_model=32,
                    seq_shares=(3.0, 2.0, 2.0, 1.0), compute_backend="kernel")
    gen = torch.Generator(device=cuda).manual_seed(0)
    layers = hmp.init_stack_params(2, 32, 16, 64, generator=gen, device=cuda)
    embed = torch.randn(300, 32, generator=gen, device=cuda) * 0.5
    ex = GalaxyHMPExecutor(layers, embed, plan, LocalRing(4))

    def run(tracer, drift):
        eng = ServingEngine(ex, max_batch=2, max_len=40, scheduler="continuous",
                            page_size=8, prefill_chunk=8, tracer=tracer, drift=drift,
                            record_times=tracer is not None)
        for i in range(4):
            eng.submit(Request(uid=i, prompt=[1 + (i * 5 + j) % 250 for j in range(6 + 4 * i)],
                               max_new_tokens=6 if i % 2 == 0 else 3))
        return eng, {r.uid: r.output for r in eng.run()}

    tracer, drift = Tracer(), DriftMonitor(lambda kind, *, rows, context: 1e-3)
    eng, traced = run(tracer, drift)
    _, plain = run(None, None)
    assert traced == plain
    assert tracer.open_spans() == [] and tracer.to_json()["traceEvents"]
    assert {r["kind"] for r in drift.records} == {"decode", "prefill_chunk"}
    assert eng.metrics.snapshot()["histograms"]["ttft_s"]["n"] == 4


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "granite-moe-3b-a800m"])
def test_moe_routing_on_the_card_equals_the_cpu(cuda, arch):
    """One MoE sub-layer at the model's full width (granite: 48 padded
    experts) on 256 tokens in fp32: the card routes every token to the
    experts the CPU does, never to a pad expert, and the output and aux
    values agree within 1e-4 relative."""
    from repro_torch.models.moe import moe_apply, moe_route

    from repro_torch.models.params import _moe_spec

    cfg = dataclasses.replace(get_config(arch), dtype="float32", param_dtype="float32")
    g = torch.Generator().manual_seed(0)
    p = {n: torch.randn(ps.shape, generator=g) / ps.shape[-2] ** 0.5
         for n, ps in _moe_spec(cfg).items()}
    x = torch.randn(2, 128, cfg.d_model, generator=g)
    pc = {n: t.to(cuda) for n, t in p.items()}
    out, aux = moe_apply(p, x, cfg)
    out_c, aux_c = moe_apply(pc, x.to(cuda), cfg)
    _, _, idx = moe_route(p, x.view(2, 128, -1), cfg)
    _, _, idx_c = moe_route(pc, x.to(cuda).view(2, 128, -1), cfg)
    assert torch.equal(idx_c.cpu(), idx) and bool((idx < cfg.num_experts).all())
    scale = out.abs().max()
    assert (out_c.cpu() - out).abs().max() <= 1e-4 * scale
    for name, val in aux.items():
        torch.testing.assert_close(aux_c[name].cpu(), val, atol=1e-4, rtol=1e-4)


def test_xlstm_chunked_equals_step_scan_on_the_card(cuda):
    """The mLSTM's chunked form and its step scan at S 256 on the card, at
    xlstm-350m's head width (4 heads of 512), from a fresh state: within
    1e-4 of the largest output."""
    from repro_torch.models import xlstm

    g = torch.Generator(device=cuda).manual_seed(0)
    b, s, nh, dh = 2, 256, 4, 512
    q, k, v = (torch.randn(b, s, nh, dh, generator=g, device=cuda) for _ in range(3))
    k = k / dh ** 0.5
    i_raw = torch.randn(b, s, nh, generator=g, device=cuda)
    f_raw = torch.randn(b, s, nh, generator=g, device=cuda) + 2.0
    cfg = get_config("xlstm-350m")
    st = tuple(xlstm.init_mlstm_cache(cfg, b, device=cuda).values())
    h_scan, st_scan = xlstm.mlstm_scan(q, k, v, i_raw, f_raw, st)
    h_chunk, st_chunk = xlstm.mlstm_chunked(q, k, v, i_raw, f_raw, st, 128)
    for a, want in zip((h_chunk,) + st_chunk, (h_scan,) + st_scan):
        assert (a - want).abs().max() <= 1e-4 * want.abs().max()


# --- the kernels' gradients (the training path) --------------------------------

def _grads(fn, inputs, weights):
    ts = [t.detach().clone().requires_grad_() for t in inputs]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    sum((o.float() * w).sum() for o, w in zip(outs, weights)).backward()
    return outs, [t.grad for t in ts]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 16, 16, 128, 64), (1, 64, 8, 256, 128)],
                         ids=["qwen", "llama_vision"])
def test_flash_attention_gradient_through_the_kernel(cuda, dtype, shape):
    """q, k, v gradients with the kernel forward (``FlashAttentionFn``)
    against autograd through the plain version, causal, on the zoo's
    transposed (B, S, H, hd) views: within 1e-4 (fp32) or 2e-2 (bf16: both
    sides' bf16 inputs and outputs round the same fp32 math) of each
    gradient's largest.  The bare wrapper's output carries no gradient
    (what training got before the Function): the fault the Function
    repairs."""
    b, h, hkv, s, hd = shape
    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn(b, s, h, hd, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(b, s, hkv, hd, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    w = torch.randn(b, h, s, hd, generator=g, device=cuda)
    view = lambda f: lambda q, k, v: f(q.transpose(1, 2), k.transpose(1, 2),  # noqa: E731
                                       v.transpose(1, 2))
    bare = flash_attention(*(t.detach().requires_grad_().transpose(1, 2) for t in (q, k, v)))
    assert not bare.requires_grad
    before = flash_attention.launches
    (out,), got = _grads(view(lambda *a: ops.flash_attention(*a, causal=True)), (q, k, v), (w,))
    assert flash_attention.launches == before + 1
    (ref,), want = _grads(view(lambda *a: flash_attention_plain(*a, causal=True)),
                          (q, k, v), (w,))
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (out.float() - ref.float()).abs().max() <= tol * ref.float().abs().max()
    for name, a, e in zip("qkv", got, want):
        assert a.dtype == dtype
        err = (a.float() - e.float()).abs().max()
        assert err <= tol * e.float().abs().max(), (name, err.item())


def test_rglru_scan_gradient_through_the_kernel(cuda):
    """da, db, dh0 with the kernel forward and the kernel backward on
    reversed time (``RGLRUScanFn``: two launches) against autograd through
    the plain scan, at RecurrentGemma's width, fp32, nonzero h0,
    gradients into h_seq and h_last: within 1e-5 of each gradient's
    largest (the same fp32 recurrence, its terms added in another
    order)."""
    from repro_torch.kernels.rglru_scan import RGLRUScanFn

    g = torch.Generator(device=cuda).manual_seed(12)
    b, s, w = 4, 300, 4096
    a = 0.5 + 0.499 * torch.rand(b, s, w, generator=g, device=cuda)
    bb = torch.randn(b, s, w, generator=g, device=cuda)
    h0 = torch.randn(b, w, generator=g, device=cuda)
    w1, w2 = torch.randn(b, s, w, generator=g, device=cuda), torch.randn(b, w, generator=g,
                                                                          device=cuda)
    before = rglru_scan.launches
    _, got = _grads(RGLRUScanFn.apply, (a, bb, h0), (w1, w2))
    assert rglru_scan.launches == before + 2
    _, want = _grads(rglru_scan_plain, (a, bb, h0), (w1, w2))
    for name, x, e in zip(("a", "b", "h0"), got, want):
        err = (x - e).abs().max()
        assert err <= 1e-5 * e.abs().max(), (name, err.item())


def _train_grads(cfg, params, batch, backend):
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train_loop import loss_fn

    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, _ = loss_fn(params, batch, cfg, backend=backend)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return loss.detach(), grads


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "recurrentgemma-9b"])
def test_remat_dots_equals_full_through_the_kernels(cuda, arch):
    """Remat "dots" (selective checkpointing: the products with no batch
    dimension saved) against "full" on the kernel backend, fp32, a reduced
    config: loss and every gradient bitwise equal, and the flash and scan
    kernels relaunched in the recompute (their ``ctypes`` outputs are
    recomputed, never cached): flash twice a layer, the scan three times."""
    from repro_torch.models.params import init_params

    cfg = dataclasses.replace(reduced(get_config(arch)), remat=True)
    params = init_params(cfg, generator=torch.Generator(device=cuda).manual_seed(3),
                         device=cuda)
    g = torch.Generator(device=cuda).manual_seed(4)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 64), generator=g, device=cuda)
             for k in ("tokens", "labels")}
    out = {}
    for policy in ("full", "dots"):
        ops.reset_launch_counts()
        out[policy] = _train_grads(dataclasses.replace(cfg, remat_policy=policy), params,
                                   batch, "kernel")
        counts = ops.launch_counts()
        assert counts["flash_attention"] == 2 * cfg.count_kind("attn"), counts
        assert counts["rglru_scan"] == 3 * cfg.count_kind("rec"), counts
    assert torch.equal(out["dots"][0], out["full"][0])
    assert all(torch.equal(a, b) for a, b in zip(out["dots"][1], out["full"][1]))


def test_chunked_eager_attention_matches_the_kernel(cuda):
    """The eager backend's query-chunked attention (``attn_chunk``) against
    the flash kernel, which ignores the chunk, on the card: fp32 logits of
    a reduced qwen prefill of 256 rows in chunks of 64 within 1e-4."""
    from repro_torch.models import apply_model
    from repro_torch.models.params import init_params
    from repro_torch.serving.kvcache import make_cache

    cfg = dataclasses.replace(reduced(get_config("qwen1.5-0.5b")), attn_chunk=64)
    params = init_params(cfg, generator=torch.Generator(device=cuda).manual_seed(5),
                         device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256),
                           generator=torch.Generator(device=cuda).manual_seed(6), device=cuda)
    logits = {}
    with torch.no_grad():
        for backend in ("kernel", "eager"):
            ops.reset_launch_counts()
            logits[backend], _ = apply_model(params, cfg, tokens=tokens, mode="prefill",
                                             cache=make_cache(cfg, 2, 256, device=cuda),
                                             backend=backend)
            launched = ops.launch_counts()["flash_attention"]
            assert launched == (cfg.count_kind("attn") if backend == "kernel" else 0)
    torch.testing.assert_close(logits["eager"], logits["kernel"], atol=1e-4, rtol=1e-4)


# --- the captured decode step (serving/graphs.py) ----------------------------------

def _clone_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return [_clone_tree(v) for v in tree]


def _serve_graphs(ex, graphs, vocab):
    """Five requests through the continuous scheduler (3 slots, pages of
    8), with ``ex.graphs`` set as asked (kept where it already is, with
    the graphs and the held pool): tokens, launches, paths, decode steps
    and the graph's stats."""
    from repro_torch.serving.engine import Request, ServingEngine

    if ex.graphs != graphs:
        ex.graphs = graphs
    eng = ServingEngine(ex, max_batch=3, max_len=48, scheduler="continuous", page_size=8)
    for i in range(5):
        eng.submit(Request(uid=i, prompt=[1 + (7 * i + 3 * j) % (vocab - 1)
                                          for j in range(5 + 6 * i)],
                           max_new_tokens=4 + i % 3))
    ops.reset_launch_counts()
    tokens = {r.uid: r.output for r in eng.run()}
    return (tokens, ops.launch_counts(), ops.path_counts(), eng.stats["decode_steps"],
            ex.graph_stats)


def _replay_equals_eager(ex, gen, tok, table, pos):
    """One decode step replayed and run eagerly on copies of one pool (the
    held pool, 13 pages of 8 drawn from ``gen``): logits and pages bitwise
    equal."""
    import copy

    eager = copy.copy(ex)
    eager.graphs = False
    ex.graphs = True
    pool = ex.make_pool(13, 8)
    for leaf in leaves(pool):
        leaf.normal_(generator=gen)
    ex.decode_paged(tok, pool, table, pos)  # warm-up and capture on `pool`
    twin = _clone_tree(pool)
    got, _ = ex.decode_paged(tok, pool, table, pos)
    want, _ = eager.decode_paged(tok, twin, table, pos)
    stats = ex.graph_stats["decode"]
    assert stats["captures"] == 1 and stats["replays"] == 1
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(leaves(pool), leaves(twin)))


def test_galaxy_graphs_replay_the_eager_step(cuda):
    """The uneven 3:2:2:1-shaped plan, 2 layers, fp16 on the kernel
    backend: a serve with graphs gives the eager serve's tokens and
    launches (32 ``tiled_gemm_valid`` a step, all ``mma``) from one
    capture; a replayed step equals the eager step bitwise."""
    from repro_torch.core import hmp
    from repro_torch.core.execplan import ExecPlan
    from repro_torch.core.ring import LocalRing
    from repro_torch.serving.galaxy import GalaxyHMPExecutor

    plan = ExecPlan(heads=(6, 4, 4, 2), columns=(24, 16, 16, 8), head_dim=2, d_model=32,
                    seq_shares=(3.0, 2.0, 2.0, 1.0), compute_backend="kernel")
    gen = torch.Generator(device=cuda).manual_seed(0)
    layers = hmp.init_stack_params(2, 32, 16, 64, generator=gen, device=cuda,
                                   dtype=torch.float16)
    embed = (torch.randn(300, 32, generator=gen, device=cuda) * 0.5).half()
    ex = GalaxyHMPExecutor(layers, embed, plan, LocalRing(4))
    eager = _serve_graphs(ex, False, 300)
    graphed = _serve_graphs(ex, True, 300)
    assert graphed[:4] == eager[:4] and eager[4] is None
    stats = graphed[4]["decode"]
    assert stats["captures"] == 1 and stats["replays"] == graphed[3] - 1
    assert graphed[2]["tiled_gemm_valid"]["fma"] == 0

    table = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], device=cuda)
    ops.reset_launch_counts()
    _replay_equals_eager(ex, gen, torch.tensor([[5], [9], [0]], device=cuda), table,
                         torch.tensor([30, 11, 0], device=cuda))
    # warm-up, replay and the eager step: 32 launches each
    assert ops.launch_counts()["tiled_gemm_valid"] == 3 * 32


def test_zoo_graphs_replay_the_eager_step(cuda):
    """Reduced StableLM (GQA 4:2) in bf16: a serve with graphs gives the
    eager serve's tokens from one capture; a replayed step equals the
    eager step bitwise."""
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import TransformerExecutor

    cfg = dataclasses.replace(reduced(get_config("stablelm-12b")), num_kv_heads=2,
                              dtype="bfloat16", param_dtype="bfloat16")
    gen = torch.Generator(device=cuda).manual_seed(0)
    ex = TransformerExecutor(init_params(cfg, generator=gen, device=cuda), cfg)
    eager = _serve_graphs(ex, False, cfg.vocab_size)
    graphed = _serve_graphs(ex, True, cfg.vocab_size)
    assert graphed[:4] == eager[:4]
    stats = graphed[4]["decode"]
    assert stats["captures"] == 1 and stats["replays"] == graphed[3] - 1

    table = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], device=cuda)
    _replay_equals_eager(ex, gen, torch.tensor([[5], [9], [0]], device=cuda), table,
                         torch.tensor([30, 11, 0], device=cuda))


def test_spec_draft_graphs_equal_eager(cuda):
    """A reduced qwen1.5-0.5b target verifying a reduced qwen1.5-0.5b draft
    (other weights) in bf16, k 3: with the draft's decode step captured
    (one capture, a replay for every later proposal step) the tokens equal
    those with it eager."""
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import Request, ServingEngine, TransformerExecutor

    cfg = dataclasses.replace(reduced(get_config("qwen1.5-0.5b")), dtype="bfloat16",
                              param_dtype="bfloat16")
    target = TransformerExecutor(init_params(
        cfg, generator=torch.Generator(device=cuda).manual_seed(0), device=cuda), cfg)
    draft = TransformerExecutor(init_params(
        cfg, generator=torch.Generator(device=cuda).manual_seed(2), device=cuda), cfg)
    out = []
    for graphs in (False, True):
        draft.graphs = graphs
        eng = ServingEngine(target, max_batch=2, max_len=48, scheduler="continuous",
                            page_size=8, draft_executor=draft, spec_k=3)
        for i in range(3):
            eng.submit(Request(uid=i, prompt=[1 + (5 * i + j) % 500 for j in range(6 + 5 * i)],
                               max_new_tokens=7))
        out.append(({r.uid: r.output for r in eng.run()}, eng.spec.steps, draft.graph_stats))
    assert out[1][:2] == out[0][:2] and out[0][2] is None
    stats = out[1][2]["decode"]
    assert stats["captures"] == 1 and stats["replays"] == out[1][1] - 1


# --- the captured chunk (serving/graphs.py, kind "chunk") ----------------------------------

KV_LEN_CASES = [  # (b, h, hkv, sq, keys in the view, kv_len per batch entry, hd)
    (1, 32, 8, 256, 97 * 16, (1280,), 160),  # StableLM-12B's chunk behind its prefix
    (1, 32, 8, 5, 97 * 16, (1029,), 160),  # its 5-row verify chunk
    (2, 14, 2, 5, 96, (37, 96), 64),  # hd 64, two batch entries
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", KV_LEN_CASES)
def test_flash_kv_len_is_bitwise_the_sliced_call(cuda, case, dtype):
    """With ``kv_len`` the kernel computes, bit for bit, the call on the
    keys sliced to ``kv_len[b]``, on the same path and with one launch."""
    b, h, hkv, sq, sk, lens, hd = case
    g = torch.Generator(device=cuda).manual_seed(sq)
    q = torch.randn(b, sq, h, hd, generator=g, device=cuda).to(dtype).transpose(1, 2)
    k, v = (torch.randn(b, sk, hkv, hd, generator=g, device=cuda).to(dtype).transpose(1, 2)
            for _ in range(2))
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    ops.reset_launch_counts()
    out = flash_attention(q, k, v, causal=True, kv_len=kv_len)
    assert flash_attention.launches == 1
    for i, n in enumerate(lens):
        want = flash_attention(q[i:i + 1], k[i:i + 1, :, :n], v[i:i + 1, :, :n], causal=True)
        assert torch.equal(out[i:i + 1], want)
    plain = flash_attention_plain(q, k, v, causal=True, kv_len=kv_len)
    torch.testing.assert_close(out.float(), plain.float(), **TOL[dtype])
    with pytest.raises(ValueError, match="int32"):
        flash_attention(q, k, v, kv_len=kv_len.long())


def _chunks_replay_equal_eager(ex, vocab, width, dtype):
    """Chunks of 5 and 8 rows on random pages, each call beside the eager
    step on a twin pool: logits and pages bitwise equal.  Each shape's first
    call is eager, its second captures; the 5-row graph (captured first)
    then replays after the 8-row one, out of capture order, and both serve
    offsets other than the one they were captured at."""
    import copy

    eager = copy.copy(ex)
    eager.graphs = False
    ex.graphs = True
    gen = torch.Generator(device=ex.device).manual_seed(1)
    pool = ex.make_pool(1 + width, 8)  # the held pool: graphs on
    for leaf in leaves(pool):
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device=ex.device).to(dtype))
    twin = _clone_tree(pool)
    row = torch.arange(1, 1 + width, device=ex.device)
    for s, off in ((5, 3), (8, 0), (5, 17), (8, 8), (5, 9), (8, 21), (5, 30), (8, 1)):
        tok = torch.randint(0, vocab, (1, s), generator=gen, device=ex.device)
        got, _ = ex.prefill_chunk(tok, pool, row, offset=off, length=off + s)
        want, _ = eager.prefill_chunk(tok, twin, row, offset=off, length=off + s)
        assert torch.equal(got, want), (s, off)
        assert all(torch.equal(a, b) for a, b in zip(leaves(pool), leaves(twin))), (s, off)
    stats = ex.graph_stats["chunk"]
    assert stats["captures"] == 2 and stats["replays"] == 6
    ex.graphs = False


def _serve_chunks(ex, graphs, vocab):
    """Four requests behind a shared 20-token prompt through the prefix
    cache and 8-token chunks (2 slots, pages of 8): tokens, launches,
    stats and the graphs' stats."""
    from repro_torch.serving.engine import Request, ServingEngine

    ex.graphs = graphs
    eng = ServingEngine(ex, max_batch=2, max_len=64, scheduler="continuous", page_size=8,
                        prefix_cache=True, prefill_chunk=8)
    shared = [1 + (3 * j) % (vocab - 1) for j in range(20)]
    for i in range(4):
        eng.submit(Request(uid=i, prompt=shared + [1 + (7 * i + j) % (vocab - 1)
                                                   for j in range(3 + 5 * i)],
                           max_new_tokens=4))
    ops.reset_launch_counts()
    tokens = {r.uid: r.output for r in eng.run()}
    return tokens, ops.launch_counts(), dict(eng.stats), ex.graph_stats


def test_galaxy_chunk_graphs_replay_the_eager_step(cuda):
    """The uneven plan's 2-layer fp16 executor: a chunked prefix-cache serve
    with graphs gives the eager serve's tokens, launches and stats, with
    chunk replays; replayed chunks equal eager chunks bitwise at offsets
    they were not captured at, two shapes out of capture order."""
    from repro_torch.core import hmp
    from repro_torch.core.execplan import ExecPlan
    from repro_torch.core.ring import LocalRing
    from repro_torch.serving.galaxy import GalaxyHMPExecutor

    plan = ExecPlan(heads=(6, 4, 4, 2), columns=(24, 16, 16, 8), head_dim=2, d_model=32,
                    seq_shares=(3.0, 2.0, 2.0, 1.0), compute_backend="kernel")
    gen = torch.Generator(device=cuda).manual_seed(0)
    layers = hmp.init_stack_params(2, 32, 16, 64, generator=gen, device=cuda,
                                   dtype=torch.float16)
    embed = (torch.randn(300, 32, generator=gen, device=cuda) * 0.5).half()
    ex = GalaxyHMPExecutor(layers, embed, plan, LocalRing(4))
    eager = _serve_chunks(ex, False, 300)
    graphed = _serve_chunks(ex, True, 300)
    assert graphed[:3] == eager[:3] and graphed[3]["chunk"]["replays"] > 0
    _chunks_replay_equal_eager(ex, 300, 5, torch.float16)


def test_zoo_chunk_graphs_replay_the_eager_step(cuda):
    """Reduced StableLM (GQA 4:2) in bf16, as the Galaxy test: the whole
    row's gather, the chunk at its device-held offset (flash with
    ``kv_len``) and the scatter replayed bitwise."""
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import TransformerExecutor

    cfg = dataclasses.replace(reduced(get_config("stablelm-12b")), num_kv_heads=2,
                              dtype="bfloat16", param_dtype="bfloat16")
    gen = torch.Generator(device=cuda).manual_seed(0)
    ex = TransformerExecutor(init_params(cfg, generator=gen, device=cuda), cfg)
    eager = _serve_chunks(ex, False, cfg.vocab_size)
    graphed = _serve_chunks(ex, True, cfg.vocab_size)
    assert graphed[:3] == eager[:3] and graphed[3]["chunk"]["replays"] > 0
    _chunks_replay_equal_eager(ex, cfg.vocab_size, 5, torch.bfloat16)


# --- the captured wave steps (serving/graphs.py, kinds "wave_prefill", "wave_decode") ------

def _wave_executor(kind, cuda):
    """A small executor of each wave-served family on the card: reduced
    RecurrentGemma (the windowed flash kernel and the scan kernel in its
    prefill) or xLSTM in bf16, or the uneven plan's 2-layer fp16 Galaxy
    executor on the kernel backend; and its vocabulary."""
    if kind == "galaxy":
        from repro_torch.core import hmp
        from repro_torch.core.execplan import ExecPlan
        from repro_torch.core.ring import LocalRing
        from repro_torch.serving.galaxy import GalaxyHMPExecutor

        plan = ExecPlan(heads=(6, 4, 4, 2), columns=(24, 16, 16, 8), head_dim=2, d_model=32,
                        seq_shares=(3.0, 2.0, 2.0, 1.0), compute_backend="kernel")
        gen = torch.Generator(device=cuda).manual_seed(0)
        layers = hmp.init_stack_params(2, 32, 16, 64, generator=gen, device=cuda,
                                       dtype=torch.float16)
        embed = (torch.randn(300, 32, generator=gen, device=cuda) * 0.5).half()
        return GalaxyHMPExecutor(layers, embed, plan, LocalRing(4)), 300
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import TransformerExecutor

    cfg = dataclasses.replace(reduced(get_config(kind)), dtype="bfloat16",
                              param_dtype="bfloat16")
    gen = torch.Generator(device=cuda).manual_seed(0)
    return TransformerExecutor(init_params(cfg, generator=gen, device=cuda), cfg), \
        cfg.vocab_size


def _serve_waves(ex, vocab, runs=1):
    """Five requests in waves of 3 and 2 rows (prompts of 12 and 8 tokens,
    ``max_batch`` 3), ``runs`` times on the executor as it stands: the
    last run's tokens, launches, paths and decode steps, and the graphs'
    stats."""
    from repro_torch.serving.engine import Request, ServingEngine

    for _ in range(runs):
        eng = ServingEngine(ex, max_batch=3, max_len=24, scheduler="wave")
        for i in range(5):
            n = 12 if i < 3 else 8
            eng.submit(Request(uid=i, prompt=[1 + (7 * i + 3 * j) % (vocab - 1)
                                              for j in range(n)], max_new_tokens=5))
        ops.reset_launch_counts()
        tokens = {r.uid: r.output for r in eng.run()}
    return (tokens, ops.launch_counts(), ops.path_counts(), eng.stats["decode_steps"],
            ex.graph_stats)


@pytest.mark.parametrize("kind", ["recurrentgemma-9b", "xlstm-350m", "galaxy"])
def test_wave_graphs_serve_the_eager_tokens(cuda, kind):
    """Waves with graphs give the eager serve's tokens, launches and paths:
    one ``wave_decode`` capture a wave batch size, every other step
    replayed; a second serve on the held caches captures the wave
    prefills (their second call) and no decode step again."""
    ex, vocab = _wave_executor(kind, cuda)
    ex.graphs = False
    eager = _serve_waves(ex, vocab)
    ex.graphs = True
    first = _serve_waves(ex, vocab)
    assert first[:4] == eager[:4] and eager[4] is None
    dec, pre = first[4]["wave_decode"], first[4]["wave_prefill"]
    assert (dec["captures"], dec["replays"]) == (2, first[3] - 2)
    assert (pre["captures"], pre["shapes"]) == (0, 2)
    second = _serve_waves(ex, vocab)
    assert second[:4] == eager[:4]
    dec, pre = second[4]["wave_decode"], second[4]["wave_prefill"]
    assert (dec["captures"], dec["replays"]) == (2, 2 * first[3] - 2)
    assert (pre["captures"], pre["replays"]) == (2, 2)
    assert second[4]["wave_caches"]["caches"] == 2
    ex.graphs = False


@pytest.mark.parametrize("kind", ["recurrentgemma-9b", "galaxy"])
def test_wave_steps_replay_the_eager_step(cuda, kind):
    """A wave prefill shape three times (eager, captured, replayed) and
    decode steps at per-row positions other than the captured ones, each
    beside the eager step on a fresh cache: logits and every cache leaf
    bitwise equal."""
    import copy

    import numpy as np

    ex, vocab = _wave_executor(kind, cuda)
    eager = copy.copy(ex)
    eager.graphs = False
    ex.graphs = True
    gen = np.random.default_rng(3)
    lengths = np.array([12, 9])
    for _ in range(3):
        tokens = gen.integers(1, vocab, (2, 12))
        cache, twin = ex.make_cache(2, 24), eager.make_cache(2, 24)
        got, _ = ex.prefill(tokens, cache, lengths=lengths)
        want, _ = eager.prefill(tokens, twin, lengths=lengths)
        assert torch.equal(got, want)
        assert all(torch.equal(a, b) for a, b in zip(leaves(cache), leaves(twin)))
    for step in (0, 1, 3, 2):
        tok = gen.integers(1, vocab, (2, 1))
        got, _ = ex.decode(tok, cache, lengths + step)
        want, _ = eager.decode(tok, twin, lengths + step)
        assert torch.equal(got, want), step
        assert all(torch.equal(a, b) for a, b in zip(leaves(cache), leaves(twin))), step
    stats = ex.graph_stats
    assert (stats["wave_prefill"]["captures"], stats["wave_prefill"]["replays"]) == (1, 2)
    assert (stats["wave_decode"]["captures"], stats["wave_decode"]["replays"]) == (1, 3)
    ex.graphs = False


# --- the captured one-shot prefill (serving/graphs.py, kind "prefill") ----------------------

@pytest.mark.parametrize("kind", ["galaxy", "stablelm-12b"])
def test_prefill_graphs_replay_the_eager_step(cuda, kind):
    """A prompt padded to 16 on the held pool (random pages), at real
    lengths 13 (eager: the warm-up), 9 (captured, then replayed) and 11
    (replayed), each beside the eager step on a twin pool: logits and every
    page bitwise equal, the same launches each call; then a second engine
    run on the executor replays its one-shot prefills and captures
    nothing new."""
    import copy

    if kind == "galaxy":
        ex, vocab = _wave_executor("galaxy", cuda)
        dtype = torch.float16
    else:
        from repro_torch.models.params import init_params
        from repro_torch.serving.engine import TransformerExecutor

        cfg = dataclasses.replace(reduced(get_config(kind)), num_kv_heads=2,
                                  dtype="bfloat16", param_dtype="bfloat16")
        gen = torch.Generator(device=cuda).manual_seed(0)
        ex = TransformerExecutor(init_params(cfg, generator=gen, device=cuda), cfg)
        vocab, dtype = cfg.vocab_size, torch.bfloat16
    eager = copy.copy(ex)
    eager.graphs = False
    ex.graphs = True
    gen = torch.Generator(device=cuda).manual_seed(4)
    pool = ex.make_pool(7, 8)
    for leaf in leaves(pool):
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device=cuda).to(dtype))
    twin = _clone_tree(pool)
    row = torch.tensor([5, 2, 3], device=cuda)
    tokens = torch.randint(1, vocab, (1, 16), generator=gen, device=cuda)
    for n in (13, 9, 11):
        ops.reset_launch_counts()
        got, _ = ex.prefill_paged(tokens, pool, row, length=n)
        launched = ops.launch_counts()
        ops.reset_launch_counts()
        want, _ = eager.prefill_paged(tokens, twin, row, length=n)
        assert torch.equal(got, want), n
        assert all(torch.equal(a, b) for a, b in zip(leaves(pool), leaves(twin))), n
        assert launched == ops.launch_counts(), n
    stats = ex.graph_stats["prefill"]
    assert (stats["captures"], stats["replays"]) == (1, 2)
    runs = []
    for _ in range(3):
        before = ex.graph_stats
        out = _serve_graphs(ex, True, vocab)
        runs.append((out[:4], stats_since(before, out[4])))
    assert runs[1][0] == runs[2][0] == runs[0][0]
    assert runs[1][1]["decode"]["captures"] == 0
    assert all(runs[2][1][k]["captures"] == 0 for k in ("decode", "prefill")), runs[2][1]
    assert runs[2][1]["prefill"]["replays"] == 5
    ex.graphs = False
