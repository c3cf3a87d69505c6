"""Host-side planning of the two GEMM kernels, in pure Python.

``plan_valid_gemm`` lays out the valid-length kernel's grid (packed short
segments, split-K slices); ``ValidGemmPlan.live_count`` walks that grid as
the kernel does and adds up what its live-tile counter adds.  The kernel
takes the plan's numbers as its arguments, so these tests pin the grid it
launches: every live K step in exactly one slice, every row of every
segment in exactly one M tile, and the counter equal to
``dense_block_count`` (the reference's analytic count) at the published
block sizes.  ``dense_path`` picks the dense kernel's path before launch.
All exact: integers only.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.tiled_gemm import (  # noqa: E402
    BLOCK_K,
    BLOCK_M,
    BLOCK_N,
    MIN_SLICE_STEPS,
    dense_block_count,
    dense_path,
    plan_valid_gemm,
    tiled_gemm,
    tiled_gemm_valid,
)

# (m, n, k, seg_m, seg_n, valid_m, valid_n, valid_k)
CASES = [
    # GPT2-L ring tiles of device 1 on the 3:2:2:1 plan: QKV, WO, W1, W2
    (57, 1536, 1280, 57, 512, 56, 320, 1280),
    (57, 1280, 512, 57, 1280, 56, 1280, 320),
    (57, 1920, 1280, 57, 1920, 56, 1280, 1280),
    (57, 1280, 1920, 57, 1280, 56, 1280, 1280),
    # the served decode: one-row segments, one per slot
    (1, 1536, 1280, 1, 512, 1, 320, 1280),
    (4, 1536, 1280, 1, 512, 1, 320, 1280),
    (16, 1536, 1280, 1, 512, 1, 320, 1280),
    (33, 1536, 1280, 1, 512, 1, 320, 1280),
    (4, 1280, 1920, 1, 1280, 1, 1280, 1280),
    (4, 1280, 512, 1, 1280, 1, 1280, 320),
    # the old 4-row decode segment
    (4, 1536, 1280, 4, 512, 4, 320, 1280),
    # ragged edges, several segments both ways
    (228, 100, 70, 57, 50, 40, 33, 65),
    (200, 130, 97, 100, 65, 99, 64, 37),
    # packing of segments that do not fill a tile: 3 of 30 rows in 2 tiles,
    # 33 of 3 rows in 2 tiles
    (90, 40, 300, 30, 40, 7, 33, 257),
    (99, 64, 64, 3, 64, 2, 64, 64),
    # all-dead rows, all-dead columns, an empty contraction, odd valid_k
    (130, 70, 33, 65, 70, 0, 70, 33),
    (64, 96, 37, 1, 96, 1, 0, 37),
    (16, 16, 16, 16, 16, 16, 16, 0),
    (8, 24, 41, 8, 24, 8, 24, 33),
]
SM_COUNTS = [132, 8, 1]


def _plan(case, sm):
    m, n, k, seg_m, seg_n, vm, vn, vk = case
    return plan_valid_gemm(m, n, k, seg_m=seg_m, seg_n=seg_n, valid_m=vm, valid_n=vn,
                           valid_k=vk, sm_count=sm)


@pytest.mark.parametrize("sm", SM_COUNTS)
@pytest.mark.parametrize("case", CASES)
def test_every_live_k_step_in_exactly_one_slice(case, sm):
    plan = _plan(case, sm)
    assert plan.k_steps == -(-case[7] // BLOCK_K)
    steps = [s for z in range(plan.splits) for s in plan.slice_steps(z)]
    assert sorted(steps) == list(range(plan.k_steps))
    assert len(steps) == len(set(steps))
    # no slice is empty, and there are never more slices than live steps
    assert all(len(plan.slice_steps(z)) > 0 for z in range(plan.splits)) or plan.k_steps == 0
    assert 1 <= plan.splits <= max(1, plan.k_steps)
    assert plan.splits == 1 or all(len(plan.slice_steps(z)) >= MIN_SLICE_STEPS
                                   for z in range(plan.splits - 1))


@pytest.mark.parametrize("sm", SM_COUNTS)
@pytest.mark.parametrize("case", CASES)
def test_m_tiles_cover_every_row_of_every_segment_once(case, sm):
    m, n, k, seg_m, seg_n, vm, vn, vk = case
    plan = _plan(case, sm)
    rows = [r for t in range(plan.m_tiles) for r in plan.m_tile_rows(t)]
    assert sorted(rows) == list(range(m)) and len(rows) == len(set(rows))
    for t in range(plan.m_tiles):
        tile = plan.m_tile_rows(t)
        assert 0 < len(tile) <= BLOCK_M
        segs = {r // seg_m for r in tile}
        if plan.pack > 1:  # whole segments only
            assert all(set(range(s * seg_m, (s + 1) * seg_m)) <= set(tile) for s in segs)
        else:              # a piece of one segment
            assert len(segs) == 1
    assert plan.pack == (BLOCK_M // seg_m if seg_m < BLOCK_M else 1)
    # N tiles stay inside their segment
    assert plan.n_tiles == (n // seg_n) * -(-seg_n // BLOCK_N)


@pytest.mark.parametrize("sm", SM_COUNTS)
@pytest.mark.parametrize("case", CASES)
def test_kernel_count_model_equals_dense_block_count(case, sm):
    m, n, k, seg_m, seg_n, vm, vn, vk = case
    plan = _plan(case, sm)
    want = dense_block_count(m, n, k, valid_m=vm, valid_n=vn, valid_k=vk, seg_m=seg_m,
                             seg_n=seg_n)
    assert plan.live_count() == want
    assert want == dense_block_count(m, n, k, valid_m=vm, valid_n=vn, valid_k=vk,
                                     seg_m=seg_m, seg_n=seg_n, block_m=BLOCK_M,
                                     block_n=BLOCK_N, block_k=BLOCK_K)
    # live tiles: what the workspace and the arrival counters are sized by
    live_m = sum(plan.m_tile_live_segments(t) > 0 for t in range(plan.m_tiles))
    live_n = sum(plan.n_tile_live(t) for t in range(plan.n_tiles))
    assert (live_m, live_n) == (plan.live_m_tiles, plan.live_n_tiles)


@pytest.mark.parametrize("case", CASES)
def test_split_fills_the_card_once(case):
    """Live tiles x slices covers 132 SMs about once, unless the live K
    steps run out first; no split without live work."""
    plan = _plan(case, 132)
    cap = max(1, plan.k_steps // MIN_SLICE_STEPS)
    if plan.live_tiles == 0 or plan.k_steps == 0:
        assert plan.splits == 1 and plan.workspace_floats == 0
        return
    assert plan.live_tiles * (plan.splits - 1) < 132
    want = -(-132 // plan.live_tiles)
    assert plan.splits <= min(want, cap)
    per = -(-plan.k_steps // min(want, cap))
    assert plan.steps_per_split == per


def test_served_shapes_split_and_workspace():
    """The ring tiles' and the decode's splits on 132 SMs, and the fp32
    workspace they need (under 4 MB)."""
    got = {name: _plan(c, 132) for name, c in
           (("qkv", CASES[0]), ("wo", CASES[1]), ("w1", CASES[2]), ("w2", CASES[3]),
            ("decode_qkv", CASES[5]), ("decode_w2", CASES[8]))}
    assert {k: (p.live_tiles, p.splits) for k, p in got.items()} == {
        "qkv": (15, 8), "wo": (20, 5), "w1": (20, 7), "w2": (20, 7),
        "decode_qkv": (15, 8), "decode_w2": (20, 7)}
    assert got["decode_qkv"].pack == BLOCK_M and got["decode_qkv"].m_tiles == 1
    assert max(4 * p.workspace_floats for p in got.values()) < 4 * 2 ** 20


def test_dense_path_is_picked_from_dtype_and_alignment():
    bf, fp, f32 = torch.bfloat16, torch.float16, torch.float32
    assert dense_path(bf, 5120, 0, 1 << 20, 5120, 13824) == "wgmma"
    assert dense_path(fp, 256, 512, 1024, 256, 128) == "wgmma"
    assert dense_path(f32, 256, 512, 1024, 256, 128) == "simt"       # fp32 stays exact
    assert dense_path(bf, 333, 512, 1024, 333, 157) == "simt"        # 666-byte rows
    assert dense_path(bf, 256, 512, 1024, 256, 157) == "simt"        # w's rows
    assert dense_path(bf, 256, 514, 1024, 256, 128) == "simt"        # base address
    assert dense_path(bf, 0, 512, 1024, 8, 128) == "simt"            # nothing to stage


def test_cpu_calls_take_no_kernel_path():
    """A CPU tensor runs the plain version: no launch, no path counted."""
    ops.reset_launch_counts()
    x, w = torch.ones(4, 16), torch.ones(16, 8)
    tiled_gemm_valid(x, w, seg_m=1, valid_n=5)
    tiled_gemm(x.bfloat16(), w.bfloat16())
    q = torch.ones(1, 2, 4, 8, dtype=torch.bfloat16)  # (B, H, S, hd)
    ops.flash_attention(q, q, q)
    qs = q.transpose(1, 2)  # the executor's (B, S, H, hd)
    ops.ragged_attention(qs, qs, qs, positions=[0, 1, -1, 2])
    ops.rglru_scan(torch.ones(1, 3, 8), torch.ones(1, 3, 8), torch.zeros(1, 8))
    ops.connective_group([x, x], [x, x], [torch.ones(16)] * 2, [torch.zeros(16)] * 2)
    assert ops.path_counts() == {"tiled_gemm_valid": {"mma": 0, "fma": 0},
                                 "ragged_flash_attention": {"mma": 0, "simt": 0},
                                 "fused_connective": {"warp": 0, "loop": 0},
                                 "flash_attention": {"mma": 0, "simt": 0},
                                 "rglru_scan": {"tma": 0, "simt": 0},
                                 "tiled_gemm": {"wgmma": 0, "simt": 0}}
    assert sum(ops.launch_counts().values()) == 0


def test_plan_refuses_bad_requests():
    with pytest.raises(ValueError):
        plan_valid_gemm(10, 8, 8, seg_m=3, seg_n=8, valid_m=1, valid_n=1, valid_k=1,
                        sm_count=132)
    with pytest.raises(ValueError):
        plan_valid_gemm(8, 8, 8, seg_m=8, seg_n=8, valid_m=1, valid_n=1, valid_k=1,
                        sm_count=0)
