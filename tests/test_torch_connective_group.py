"""The grouped connective: every shard of one connective site in one launch.

``fused_connective_group_plain`` (what CPU tensors run) against the
reference's Pallas ``fused_connective`` in interpret mode, shard by shard,
on the same numpy inputs: shards of unequal rows and an empty one, with
dropout off and on, each shard's rows one Pallas block.  Tolerance: fp32
atol=rtol=1e-5, the sums of a row taken in another order.  Then the
packing the kernel launches from (``pack_group``): each launch's shards
in order, the prefix of their row counts and a grid of enough warps for
every row, and more shards than one launch carries split into several
launches.  Which warp takes which row is the kernel's, checked on the
card by its outputs over unequal and empty shards.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.fused_connective import fused_connective as j_connective  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.fused_connective import (  # noqa: E402
    MAX_SHARDS,
    ROWS_PER_BLOCK,
    connective_path,
    fused_connective_group,
    fused_connective_group_plain,
    pack_group,
)

TOL = dict(atol=1e-5, rtol=1e-5)
# a GPT2-L site's tiles on the 3:2:2:1 plan, then an empty shard
ROWS = (57, 56, 56, 31, 0)


def _group(rows, d, rate, seed):
    rng = np.random.default_rng(seed)
    shards = []
    for s in rows:
        x, res = (rng.normal(size=(s, d)).astype(np.float32) for _ in range(2))
        keep = (rng.uniform(size=(s, d)) > rate).astype(np.float32)
        scale = (1 + 0.1 * rng.normal(size=d)).astype(np.float32)
        bias = (0.1 * rng.normal(size=d)).astype(np.float32)
        shards.append((x, res, keep, scale, bias))
    return shards


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_group_plain_matches_pallas_per_shard(rate):
    d = 64
    shards = _group(ROWS, d, rate, seed=int(rate * 10))
    cols = [[torch.from_numpy(s[i]) for s in shards] for i in range(5)]
    outs = fused_connective_group_plain(*cols, rate=rate)
    assert [tuple(o.shape) for o in outs] == [(s, d) for s in ROWS]
    for (x, res, keep, scale, bias), out in zip(shards, outs):
        if not len(x):
            continue
        jout = j_connective(*(jnp.asarray(a) for a in (x, res, keep, scale, bias)),
                            rate=rate, block_s=len(x), interpret=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    # the wrapper on CPU tensors is the plain version, with no launch
    launches = fused_connective_group.launches
    again = fused_connective_group(*cols, rate=rate)
    assert all(torch.equal(a, b) for a, b in zip(again, outs))
    assert fused_connective_group.launches == launches


def test_ops_group_keeps_leading_dims():
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(1, s, 16, generator=g) for s in (5, 3, 0)]
    rs = [torch.randn(1, s, 16, generator=g) for s in (5, 3, 0)]
    sc, bi = [torch.ones(16)] * 3, [torch.zeros(16)] * 3
    outs = ops.connective_group(xs, rs, sc, bi)
    assert [o.shape for o in outs] == [x.shape for x in xs]
    for x, r, o in zip(xs, rs, outs):
        torch.testing.assert_close(o, ops.connective(x, r, sc[0], bi[0]))
    with pytest.raises(ValueError, match="keep_mask"):
        fused_connective_group([x[0] for x in xs], [r[0] for r in rs], None, sc, bi,
                               rate=0.1)


@pytest.mark.parametrize("rows", [ROWS, (1,), (4, 0, 4), (0, 0), tuple(range(11)),
                                  (57,) * 9, (3, 0, 2, 0, 9, 1, 1, 6, 5, 2, 7)])
def test_packing_covers_every_row_once_and_splits_past_max_shards(rows):
    launches = pack_group(rows)
    live = [i for i, s in enumerate(rows) if s]
    assert len(launches) == -(-len(live) // MAX_SHARDS)
    assert [i for ln in launches for i in ln.shards] == live
    for ln in launches:
        assert 1 <= len(ln.shards) <= MAX_SHARDS
        assert ln.row0[0] == 0 and list(ln.row0[1:]) == list(
            np.cumsum([rows[i] for i in ln.shards]))
        assert ln.blocks == -(-ln.row0[-1] // ROWS_PER_BLOCK)
    # every row of every shard with rows lies in exactly one launch's grid
    assert sum(ln.row0[-1] for ln in launches) == sum(rows)


def test_path_needs_register_rows_and_16_byte_alignment():
    f16, f32 = torch.float16, torch.float32
    assert connective_path(f16, 1280, [0, 256], [1280, 1280]) == "warp"   # GPT2-L
    assert connective_path(f32, 2560, [0, 256], [2560, 2560]) == "warp"   # widest held
    assert connective_path(f32, 768, [0, 256], [768, 768]) == "warp"
    assert connective_path(f16, 2568, [0, 256], [2568, 2568]) == "loop"   # too wide
    assert connective_path(f16, 5000, [0, 256], [5000, 5000]) == "loop"
    assert connective_path(f16, 1284, [0, 256], [1284, 1284]) == "loop"   # d % 8
    assert connective_path(f32, 8, [0, 8], [8, 8]) == "loop"              # base address
    assert connective_path(f16, 1280, [0, 256], [1280, 1284]) == "loop"   # a row stride
