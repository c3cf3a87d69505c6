"""The model zoo's two kernels — dense flash attention and the RG-LRU scan —
as their plain PyTorch versions (what a CPU tensor runs) against the
reference's Pallas kernels in interpret mode and its jnp oracles
(``kernels/ref.py``), on the same numpy inputs.

Tolerances: fp32 throughout.  Attention atol=rtol=1e-5: softmax-weighted
sums of O(1) values taken in another order (the interpreted online
softmax vs one softmax over the whole row).  Scan atol=rtol=1e-5: the
same recurrence in fp32 over at most 64 steps, so the two sides differ
by rounding alone.
"""
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread, so the xdist workers beside it keep their cores
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan_kernel as j_scan  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_plain  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(b, h, hkv, sq, sk, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, hd), np.float32),
            rng.standard_normal((b, hkv, sk, hd), np.float32),
            rng.standard_normal((b, hkv, sk, hd), np.float32))


@pytest.mark.parametrize("b,h,hkv,s,hd,window", [
    (2, 4, 2, 64, 32, 0),    # GQA 2:1, causal
    (1, 2, 1, 64, 16, 12),   # MQA, window < block: whole key blocks masked
])
def test_plain_flash_matches_pallas_kernel(b, h, hkv, s, hd, window):
    q, k, v = _qkv(b, h, hkv, s, s, hd, seed=s + hd + window)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                   window=window, block_q=16, block_k=16, interpret=True)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("sq,sk,causal,window", [
    (37, 37, True, 16),     # the zoo's prefill: MQA, hd 256, not a block multiple
    (13, 45, True, 20),     # queries right-aligned to longer keys
    (29, 29, False, 8),     # window without causality: keys on both sides
])
def test_plain_flash_hd256_mqa_matches_oracle(sq, sk, causal, window):
    q, k, v = _qkv(1, 4, 1, sq, sk, 256, seed=sq * sk)
    want = ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=causal, window=window)
    args = [torch.from_numpy(t) for t in (q, k, v)]
    got = flash_attention(*args, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the zoo's (B, S, H, hd) projections arrive as transposed views
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in args]
    for backend in ("kernel", "eager"):
        out = ops.flash_attention(*views, causal=causal, window=window, backend=backend)
        torch.testing.assert_close(out, got, rtol=0, atol=0)


def test_flash_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, 4, 2, 8, 6, 16, seed=0))
    with pytest.raises(ValueError, match="Sq <= Sk"):
        flash_attention(q, k, v)
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, 3, 2, 6, 6, 16, seed=0))
    with pytest.raises(ValueError, match="shapes differ"):
        flash_attention(q, k, v)
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, 2, 1, 6, 6, 16, seed=0))
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=-1)
    with pytest.raises(ValueError, match="unknown compute backend"):
        ops.flash_attention(q, k, v, backend="pallas")
    with pytest.raises(ValueError, match="no flash_attention kernel"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert flash_attention.launches == 0  # the CPU path launches nothing


def _scan_inputs(b, s, w, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (b, s, w)).astype(np.float32)
    bb = rng.standard_normal((b, s, w), np.float32)
    h0 = rng.standard_normal((b, w), np.float32)
    return a, bb, h0


def test_plain_scan_matches_pallas_kernel():
    a, bb, h0 = _scan_inputs(2, 64, 64, seed=1)
    hs, hl = j_scan(jnp.asarray(a), jnp.asarray(bb), jnp.asarray(h0),
                    block_s=32, block_w=32, interpret=True)
    got_s, got_l = rglru_scan(*(torch.from_numpy(t) for t in (a, bb, h0)))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(hs), **TOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(hl), **TOL)


@pytest.mark.parametrize("b,s,w", [(3, 37, 50), (1, 1, 7)])
def test_plain_scan_any_shape_matches_oracle(b, s, w):
    """Shapes the Pallas kernel's tiling assert refuses."""
    a, bb, h0 = _scan_inputs(b, s, w, seed=s * w)
    rs, rl = ref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(bb), jnp.asarray(h0))
    got_s, got_l = ops.rglru_scan(*(torch.from_numpy(t) for t in (a, bb, h0)))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(rs), **TOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(rl), **TOL)
    eager = ops.rglru_scan(*(torch.from_numpy(t) for t in (a, bb, h0)), backend="eager")
    torch.testing.assert_close(eager[0], got_s, rtol=0, atol=0)


def test_scan_keeps_dtype_and_carries_fp32():
    a, bb, h0 = (torch.from_numpy(t) for t in _scan_inputs(2, 9, 5, seed=3))
    hs, hl = rglru_scan_plain(a.bfloat16(), bb.bfloat16(), h0)
    assert hs.dtype == hl.dtype == torch.bfloat16
    want_s, want_l = rglru_scan_plain(a.bfloat16().float(), bb.bfloat16().float(), h0)
    torch.testing.assert_close(hs, want_s.bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(hl, want_l.bfloat16(), rtol=0, atol=0)
    with pytest.raises(ValueError, match="rglru_scan shapes"):
        rglru_scan(a, bb[:, :4], h0)
    with pytest.raises(ValueError, match="at least one"):
        rglru_scan(a[:, :0], bb[:, :0], h0)
