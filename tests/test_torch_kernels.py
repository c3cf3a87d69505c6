"""The kernels' plain PyTorch versions (what a CPU tensor runs) against the
reference's Pallas kernels in interpret mode, on the same numpy inputs.

Tolerances: fp32 throughout, atol=rtol=1e-5 — the two sides sum in a
different order (PyTorch's CPU matmul vs the interpreted block loop), which
moves the last few bits of O(10) sums of O(1) products.  Pad outputs are
compared exactly: they must be exact zeros whatever the pads hold.
"""
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread, so the xdist workers beside it keep their cores
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.execplan import SeqLayout as JSeqLayout  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    attention_block_map as j_block_map,
    ragged_flash_attention as j_ragged_flash,
)
from repro.kernels.fused_connective import fused_connective as j_connective  # noqa: E402
from repro.kernels.tiled_gemm import divisor_block as j_divisor_block  # noqa: E402
from repro.kernels.tiled_gemm import tiled_gemm_valid as j_gemm_valid  # noqa: E402
from repro_torch.core.execplan import SeqLayout  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_block_map,
    ragged_flash_attention,
)
from repro_torch.kernels.fused_connective import fused_connective  # noqa: E402
from repro_torch.kernels.tiled_gemm import (  # noqa: E402
    BLOCK_K,
    BLOCK_M,
    BLOCK_N,
    dense_block_count,
    divisor_block,
    tiled_gemm_valid,
)

TOL = dict(atol=1e-5, rtol=1e-5)
B4 = dict(block_m=4, block_n=4, block_k=4)


def _seg_mask(extent, seg, valid):
    return (np.arange(extent) % seg) < valid


# (m, n, k, valid_m, valid_n, valid_k, seg_m, seg_n): multiples of the
# reference's 4-blocks, as in tests/test_kernels_ragged.py, plus segments
# (batch rows folded into M, the q/k/v thirds of a fused QKV weight)
GEMM_CASES = [
    (16, 12, 20, 9, 5, 13, None, None),
    (8, 24, 8, 8, 24, 8, None, None),       # fully valid
    (12, 8, 12, 0, 3, 4, None, None),       # zero valid rows: all pad
    (16, 16, 24, 3, 16, 1, None, None),
    (24, 24, 16, 5, 7, 9, 12, 12),          # 2 x 2 segments
    (16, 36, 12, 6, 4, 12, 8, 12),          # fused-QKV-like column thirds
    (20, 8, 16, 2, 8, 0, 4, None),          # empty contraction
]


@pytest.mark.parametrize("case", GEMM_CASES)
def test_valid_gemm_plain_matches_pallas(case):
    m, n, k, vm, vn, vk, seg_m, seg_n = case
    rng = np.random.default_rng(m * 1000 + n * 10 + k)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    rows = _seg_mask(m, seg_m or m, vm)
    cols = _seg_mask(n, seg_n or n, vn)
    kk = np.arange(k) < vk
    # garbage in every pad region
    x[~rows] = rng.normal(size=(int((~rows).sum()), k)) * 100
    x[:, ~kk] = rng.normal(size=(m, int((~kk).sum()))) * 100
    w[~kk] = rng.normal(size=(int((~kk).sum()), n)) * 100
    w[:, ~cols] = rng.normal(size=(k, int((~cols).sum()))) * 100
    kw = dict(valid_m=vm, valid_n=vn, valid_k=vk, seg_m=seg_m, seg_n=seg_n)

    jout, jcnt = j_gemm_valid(jnp.asarray(x), jnp.asarray(w), count_blocks=True,
                              interpret=True, **kw, **B4)
    out, cnt = tiled_gemm_valid(torch.from_numpy(x), torch.from_numpy(w),
                                count_blocks=True, **kw)
    out = out.numpy()
    np.testing.assert_allclose(out, np.asarray(jout), **TOL)
    assert not np.any(out[~rows]) and not np.any(out[:, ~cols])
    # the clean dense product over zero-compacted operands
    xc = np.where(rows[:, None] & kk[None, :], x, 0)
    wc = np.where(kk[:, None] & cols[None, :], w, 0)
    np.testing.assert_allclose(out, np.where(rows[:, None] & cols[None, :],
                                             xc @ wc, 0), **TOL)
    # live-tile count: at equal block sizes the analytic count equals the
    # reference kernel's measured counter; the port's own count is taken
    # at the CUDA kernel's tile sizes
    assert int(jcnt) == dense_block_count(m, n, k, **kw, **B4)
    assert int(cnt) == dense_block_count(m, n, k, **kw)
    assert (BLOCK_M, BLOCK_N, BLOCK_K) == (64, 64, 32)


@pytest.mark.parametrize("extent,preferred", [(57, 64), (228, 64), (16, 4), (13, 5), (1, 8)])
def test_divisor_block_matches_reference(extent, preferred):
    assert divisor_block(extent, preferred) == j_divisor_block(extent, preferred)


def test_ops_gemm_backends_agree_on_folded_segments():
    """ops.gemm folds leading dims into M segments; the eager (masked
    dense) and kernel backends compute the same function of the valid
    regions."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 8, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(16, 12)).astype(np.float32))
    kw = dict(valid_m=5, valid_n=3, valid_k=11, seg_n=4)
    a = ops.gemm(x, w, backend="eager", **kw)
    b = ops.gemm(x, w, backend="kernel", **kw)
    torch.testing.assert_close(a, b, **TOL)
    assert not b[:, 5:].any() and not b[..., 3::4].any()
    with pytest.raises(ValueError, match="backend"):
        ops.gemm(x, w, backend="xla")
    with pytest.raises(ValueError, match="count_blocks"):
        ops.gemm(x, w, backend="eager", count_blocks=True)
    with pytest.raises(ValueError, match="seg_m"):
        tiled_gemm_valid(x[0], w, seg_m=3)


# (tiles, heads, kv heads, valid heads): ragged layouts with pad rows
# (a zero tile included) and pad head slots, plus one GQA case with g=2
ATTN_CASES = [
    ((5, 3, 0, 6), 4, 4, 3),
    ((4, 4, 4, 4), 2, 2, 2),
    ((6, 1), 3, 3, 1),
    ((0, 2, 5), 4, 4, 4),
    ((6, 3, 3, 2), 4, 2, 3),
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_ragged_flash_plain_matches_pallas(case):
    tiles, h, hkv, vh = case
    lay = SeqLayout(tiles)
    s, hd, b = lay.padded_len, 8, 2
    rng = np.random.default_rng(s * 10 + h)
    q = rng.normal(size=(b, h, s, hd)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, hd)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, hd)).astype(np.float32)
    clean = [a.copy() for a in (q, k, v)]
    pad = ~lay.valid
    for a in (q, k, v):  # garbage in pad rows and pad head slots
        a[:, :, pad] = rng.normal(size=(b, a.shape[1], int(pad.sum()), hd)) * 100
    q[:, vh:] = rng.normal(size=(b, h - vh, s, hd)) * 100

    jout = np.asarray(j_ragged_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        positions=lay.positions, valid_heads=vh, block_q=4, block_k=4,
        interpret=True))
    out = ragged_flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        positions=lay.positions, valid_heads=vh).numpy()
    assert not np.any(out[:, :, pad]), "pad rows must be exactly zero"
    assert not np.any(out[:, vh:]), "pad head slots must be exactly zero"
    np.testing.assert_allclose(out, jout, **TOL)
    # valid rows == the dense causal oracle over the compacted sequence
    qc, kc, vc = (a[:, :, lay.rows] for a in clean)
    expected = np.asarray(ref.flash_attention_ref(
        jnp.asarray(qc), jnp.asarray(kc), jnp.asarray(vc), causal=True))
    np.testing.assert_allclose(out[:, :vh][:, :, lay.rows], expected[:, :vh], **TOL)


@pytest.mark.parametrize("tiles", [(5, 3, 0, 6), (4, 4, 4, 4), (57, 56, 56, 31)])
def test_attention_block_map_matches_reference(tiles):
    pos = SeqLayout(tiles).positions
    np.testing.assert_array_equal(pos, JSeqLayout(tiles).positions)
    for bq, bk in ((4, 4), (2, 4)):
        np.testing.assert_array_equal(attention_block_map(pos, bq, bk),
                                      j_block_map(pos, bq, bk))
    # non-dividing lengths: rows past the end of the last block are pad
    bm = attention_block_map(pos, 64, 64)
    n = -(-len(pos) // 64)
    padded = np.concatenate([pos, -np.ones(n * 64 - len(pos), int)])
    np.testing.assert_array_equal(bm, j_block_map(padded, 64, 64))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("s,d", [(256, 128), (512, 256), (128, 512)])
def test_fused_connective_plain_matches_pallas(s, d, rate):
    rng = np.random.default_rng(s + d)
    x = rng.normal(size=(s, d)).astype(np.float32)
    res = rng.normal(size=(s, d)).astype(np.float32)
    keep = (rng.uniform(size=(s, d)) > rate).astype(np.float32)
    scale = np.full(d, 1.3, np.float32)
    bias = np.full(d, 0.05, np.float32)
    jout = j_connective(*(jnp.asarray(a) for a in (x, res, keep, scale, bias)),
                        rate=rate, block_s=128, interpret=True)
    out = fused_connective(*(torch.from_numpy(a) for a in (x, res, keep, scale, bias)),
                           rate=rate)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


def test_fused_connective_takes_any_row_count():
    """The reference's block_s tiling constraint is gone; the keep mask is
    required only when dropout is on."""
    x = torch.randn(100, 8, generator=torch.Generator().manual_seed(0))
    out = ops.connective(x, x, torch.ones(8), torch.zeros(8))
    assert out.shape == (100, 8) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="keep_mask"):
        fused_connective(x, x, None, torch.ones(8), torch.zeros(8), rate=0.1)
