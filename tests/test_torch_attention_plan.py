"""Host-side planning of the two attention kernels, in pure Python.

``attention_path`` picks the path ("mma": bf16/fp16 on the tensor cores,
"simt": fp32 on the CUDA cores) before the launch, ``head_dim_instance``
the kernel instantiation a head dim runs, ``attention_tiles`` and
``attention_grid`` the tiles and the grid (which the kernels check),
``dense_key_blocks`` the key blocks a dense q tile loops over, and
``ragged_block_kinds`` the ragged kernel's map of (q tile, key block)
pairs: dead, live and masked, or live and whole.  A row's 16-byte
alignment picks the copy mode inside either kernel, not the path; the
``cuda`` tests pin that on the card.  All exact: integers only.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.kernels.flash_attention import attention_block_map as j_block_map  # noqa: E402
from repro_torch.core.execplan import SeqLayout  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    DENSE_TILES,
    RAGGED_TILES,
    attention_block_map,
    attention_grid,
    attention_path,
    attention_tiles,
    dense_key_blocks,
    head_dim_instance,
    ragged_block_kinds,
)

BF, FP, F32 = torch.bfloat16, torch.float16, torch.float32
# every head dim the tests and the serves use: the tests' 8, 32, 40, 96,
# 128; GPT2-L's 64; StableLM-12B's 160; RecurrentGemma-9B's 256
DENSE_HDS = [8, 32, 40, 64, 96, 128, 160, 256]
RAGGED_HDS = [8, 32, 40, 64, 96, 128]


@pytest.mark.parametrize("hd", DENSE_HDS)
@pytest.mark.parametrize("dtype,path", [(BF, "mma"), (FP, "mma"), (F32, "simt")])
def test_dense_path_and_instance(dtype, path, hd):
    assert attention_path(dtype, hd) == path
    want = {"mma": {8: 64, 32: 64, 40: 64, 64: 64, 96: 128, 128: 128, 160: 160, 256: 256},
            "simt": {8: 64, 32: 64, 40: 64, 64: 64, 96: 128, 128: 128, 160: 256, 256: 256}}
    assert head_dim_instance(hd, path) == want[path][hd]


@pytest.mark.parametrize("hd", RAGGED_HDS)
@pytest.mark.parametrize("dtype,path", [(BF, "mma"), (FP, "mma"), (F32, "simt")])
def test_ragged_path_and_instance(dtype, path, hd):
    assert attention_path(dtype, hd, ragged=True) == path
    want = {8: 32, 32: 32, 40: 64, 64: 64, 96: 128, 128: 128}
    assert head_dim_instance(hd, path, ragged=True) == want[hd]


def test_paths_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="float32/bfloat16/float16"):
        attention_path(torch.float64, 64)
    with pytest.raises(ValueError, match="head_dim 300"):
        attention_path(BF, 300)
    with pytest.raises(ValueError, match="head_dim 160"):
        attention_path(FP, 160, ragged=True)
    with pytest.raises(ValueError, match="head_dim 257"):
        head_dim_instance(257, "mma")


def test_tiles_and_grids_at_the_served_shapes():
    # RecurrentGemma-9B's prefill: 33 q tiles of 64 rows, 32-key blocks at
    # instantiation 256; StableLM-12B's 256-query chunk: 4 q tiles of 64
    assert attention_tiles("mma", 256) == (64, 32)
    assert attention_tiles("mma", 160) == (64, 64)
    assert attention_tiles("simt", 256) == (64, 64)
    assert attention_grid(2, 16, 2100, "mma") == (33, 16, 2)
    assert attention_grid(1, 32, 256, "mma") == (4, 32, 1)
    # the Galaxy shard of device 1: 228 padded rows, 8 head slots; the
    # tensor-core kernel's 32-row tiles launch 64 blocks, the CUDA-core
    # kernel's 64-row tiles 32 (and 20 with a valid head)
    assert attention_tiles("mma", 64, ragged=True) == RAGGED_TILES["mma"] == (32, 64)
    assert attention_grid(1, 8, 228, "mma", ragged=True) == (8, 8, 1)
    assert attention_grid(1, 8, 228, "simt", ragged=True) == (4, 8, 1)
    assert DENSE_TILES["mma"][0] == 64


def _served_layout():
    return SeqLayout((57, 56, 56, 31))  # GPT2-L 3:2:2:1 at a 200-token prompt


def _random_layouts(n=12, seed=0):
    rng = np.random.default_rng(seed)
    out = [_served_layout()]
    for _ in range(n):
        d = int(rng.integers(1, 6))
        tiles = tuple(int(x) for x in rng.integers(0, 80, size=d))
        # empty tiles (a device with no rows) allowed, an empty layout not
        out.append(SeqLayout(tiles if sum(tiles) else tiles[:-1] + (1,)))
    return out


def _pad_to(pos, block):
    n = -(-len(pos) // block) * block
    return np.concatenate([pos, -np.ones(n - len(pos), int)])


@pytest.mark.parametrize("lay", _random_layouts(), ids=lambda lay: str(lay.tiles))
@pytest.mark.parametrize("path", ["mma", "simt"])
def test_ragged_live_map_equals_the_reference(lay, path):
    bq, bk = RAGGED_TILES[path]
    pos = lay.positions
    live = attention_block_map(pos, bq, bk)
    # the reference takes lengths its blocks divide: pad the rows past the
    # end of the last block, as the kernel treats them
    want = j_block_map(_pad_to(_pad_to(pos, bq), bk), bq, bk)
    np.testing.assert_array_equal(live, want[:live.shape[0], :live.shape[1]])
    assert not want[live.shape[0]:].any() and not want[:, live.shape[1]:].any()


@pytest.mark.parametrize("lay", _random_layouts(seed=1), ids=lambda lay: str(lay.tiles))
def test_ragged_block_kinds_split_the_live_map(lay):
    """0 = dead, 1 = live with some hidden pair (masked), 2 = live with every
    (query, key) pair valid and visible (unmasked), by brute force over the
    pairs of every block."""
    bq, bk = RAGGED_TILES["mma"]
    pos = lay.positions
    kinds = ragged_block_kinds(pos, bq, bk)
    np.testing.assert_array_equal(kinds > 0, attention_block_map(pos, bq, bk) > 0)
    qp, kp = _pad_to(pos, bq), _pad_to(pos, bk)
    for i in range(kinds.shape[0]):
        for j in range(kinds.shape[1]):
            q = qp[i * bq:(i + 1) * bq][:, None]
            k = kp[j * bk:(j + 1) * bk][None, :]
            vis = (q >= 0) & (k >= 0) & (k <= q)
            assert kinds[i, j] == (0 if not vis.any() else 2 if vis.all() else 1)


def test_ragged_block_kinds_at_the_served_layout():
    kinds = ragged_block_kinds(_served_layout().positions, 32, 64)
    # 8 q tiles (the last all pad) x 4 key blocks: a causal staircase of 16
    # live blocks; the pad rows 113, 170 and 201-227 and the diagonal leave
    # two of them whole (unmasked)
    np.testing.assert_array_equal(kinds, [[1, 0, 0, 0], [1, 0, 0, 0], [2, 1, 0, 0],
                                          [1, 1, 0, 0], [2, 1, 1, 0], [1, 1, 1, 0],
                                          [1, 1, 1, 1], [0, 0, 0, 0]])


def _visible(sq, sk, causal, window):
    qp = np.arange(sq)[:, None] + (sk - sq)
    kp = np.arange(sk)[None, :]
    vis = np.ones((sq, sk), bool)
    if causal:
        vis &= kp <= qp
    if window > 0:
        vis &= kp > qp - window
    return vis


# (sq, sk, causal, window, block_q, block_k): the served prefill (sq == sk,
# window < S), chunks at offsets (sq < sk), windows with and without
# causality, one query row, tails that no block divides
RANGE_CASES = [
    (2100, 2100, True, 2048, 64, 32),
    (256, 1280, True, 0, 64, 64),
    (37, 300, True, 0, 64, 64),
    (77, 200, True, 50, 64, 64),
    (100, 100, False, 17, 64, 32),
    (1, 40, True, 8, 64, 64),
    (65, 65, False, 0, 64, 64),
    (130, 130, True, 0, 64, 32),
]


@pytest.mark.parametrize("case", RANGE_CASES)
def test_dense_key_blocks_cover_exactly_the_visible_pairs(case):
    sq, sk, causal, window, bq, bk = case
    vis = _visible(sq, sk, causal, window)
    nkb = -(-sk // bk)
    for t in range(-(-sq // bq)):
        rows = vis[t * bq:(t + 1) * bq]
        blocks = dense_key_blocks(t, sq, sk, causal=causal, window=window,
                                  block_q=bq, block_k=bk)
        for j in range(nkb):
            holds = rows[:, j * bk:(j + 1) * bk].any()
            # every visible pair in a block of the range, every block of the
            # range holding one
            assert holds == (j in blocks), (t, j, list(blocks))


@pytest.mark.parametrize("case", [c for c in RANGE_CASES if c[2]])
def test_window_pairs_counts_the_visible_pairs(case):
    """The pair count behind the smoke's and ``attention_times``' bounds
    is the plain mask's."""
    from repro_torch.launch.kernel_timing import window_pairs

    sq, sk, _, window = case[:4]
    assert window_pairs(sq, sk, window) == int(_visible(sq, sk, True, window).sum())


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114mma_kernelI6__halfLi64EEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114mma_kernelI6__halfLi64EEEvPKT_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 144 registers, used 1 barriers
ptxas info    : Function properties for _ZN12_GLOBAL__N_19copy_rowsEv
    0 bytes stack frame
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114mma_kernelI6__halfLi256EEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114mma_kernelI6__halfLi256EEEvPKT_
    88 bytes stack frame, 56 bytes spill stores, 88 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 88 bytes cumulative stack size
"""


def test_ptxas_spills_are_read_per_function():
    """``build.spills`` reads the smoke's spill check from a ``ptxas -v``
    log: each function's stores and loads, a function without a spill
    line left out."""
    from repro_torch.kernels import build

    assert build.spills(PTXAS_LOG) == {
        "_ZN12_GLOBAL__N_114mma_kernelI6__halfLi64EEEvPKT_": (0, 0),
        "_ZN12_GLOBAL__N_114mma_kernelI6__halfLi256EEEvPKT_": (56, 88),
    }
    assert build.spills("") == {}
