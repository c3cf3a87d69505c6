"""Host-side planning of the RG-LRU scan kernel, in pure Python.

``plan_scan`` lays out the scan kernel's launch: the path, the column
strip a block owns, the TMA ring's rows and stages, the grid and the
shared memory a block takes.  The kernel takes the plan's numbers as its
arguments and refuses any it does not build, so these tests pin what it
launches: every column of every batch row in exactly one block, shared
memory inside what an H100 block and SM hold, and the TMA path exactly
where rows are 16-byte multiples on aligned inputs.  All exact: integers
only.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.rglru_scan import (  # noqa: E402
    BLOCK_RESERVED,
    BLOCK_SMEM,
    MAX_STAGES,
    SM_SMEM,
    STAGE_BYTES,
    STATIC_SMEM,
    STRIP,
    plan_scan,
    rglru_scan,
    rglru_scan_plain,
)

# (b, s, w): RecurrentGemma-9B's two served prefill waves, then S = 1, S
# shorter than a stage, B = 1, and the odd widths of the card tests
CASES = [(4, 300, 4096), (2, 2100, 4096), (1, 1, 4096), (3, 17, 256), (1, 2100, 4096),
         (1, 1, 7), (3, 37, 50), (2, 9, 129), (2, 40, 40), (64, 5, 4096)]
ESIZES = [4, 2]


@pytest.mark.parametrize("esize", ESIZES)
@pytest.mark.parametrize("case", CASES)
def test_grid_covers_every_column_once(case, esize):
    b, s, w = case
    plan = plan_scan(b, s, w, esize, 132)
    strips, rows = plan.grid
    assert rows == b
    cols = [c for i in range(strips) for c in range(i * plan.strip, (i + 1) * plan.strip)
            if c < w]
    assert cols == list(range(w))
    # no block owns only columns past w
    assert (strips - 1) * plan.strip < w <= strips * plan.strip


@pytest.mark.parametrize("esize", ESIZES)
@pytest.mark.parametrize("case", CASES)
def test_shared_memory_fits_a_block_and_the_resident_blocks_an_sm(case, esize):
    b, s, w = case
    plan = plan_scan(b, s, w, esize, 132)
    assert plan.smem_bytes + STATIC_SMEM <= BLOCK_SMEM
    if plan.path == "simt":
        assert (plan.rows, plan.stages, plan.smem_bytes) == (0, 0, 0)
        return
    assert plan.strip == STRIP and plan.rows * STRIP * esize * 2 == STAGE_BYTES
    tiles = -(-s // plan.rows)
    assert 1 <= plan.stages <= min(MAX_STAGES, max(2, tiles)) and plan.stages <= tiles
    per_sm = -(-plan.grid[0] * plan.grid[1] // 132)
    if plan.stages > 2:  # a deeper ring only where the resident blocks all fit
        assert per_sm * (plan.smem_bytes + STATIC_SMEM + BLOCK_RESERVED) <= SM_SMEM


@pytest.mark.parametrize("esize", ESIZES)
@pytest.mark.parametrize("case", CASES)
def test_tma_path_exactly_where_rows_are_16_byte_aligned(case, esize):
    b, s, w = case
    aligned_rows = (w * esize) % 16 == 0
    assert (plan_scan(b, s, w, esize, 132).path == "tma") == aligned_rows
    assert plan_scan(b, s, w, esize, 132, aligned=False).path == "simt"


def test_served_shapes():
    """Both waves on the TMA path on 132 SMs: 512 blocks four to an SM
    with 6 stages, then 256 blocks two to an SM with the full 8."""
    wave1, wave2 = plan_scan(4, 300, 4096, 4, 132), plan_scan(2, 2100, 4096, 4, 132)
    assert (wave1.path, wave1.grid, wave1.rows, wave1.stages) == ("tma", (128, 4), 32, 6)
    assert (wave2.path, wave2.grid, wave2.rows, wave2.stages) == ("tma", (128, 2), 32, 8)
    assert wave2.smem_bytes == 8 * STAGE_BYTES + 128
    bf16 = plan_scan(2, 2100, 4096, 2, 132)
    assert (bf16.path, bf16.rows, bf16.stages) == ("tma", 64, 8)


def test_plan_refuses_bad_requests():
    for args in ((0, 1, 8, 4, 132), (1, 0, 8, 4, 132), (1, 1, 8, 8, 132), (1, 1, 8, 4, 0)):
        with pytest.raises(ValueError):
            plan_scan(*args)


def test_cpu_scan_takes_the_plain_version():
    """A CPU tensor runs the plain recurrence: no launch, no path."""
    g = torch.Generator().manual_seed(0)
    a, b = torch.rand(2, 5, 7, generator=g), torch.randn(2, 5, 7, generator=g)
    h0 = torch.randn(2, 7, generator=g)
    launches, paths = rglru_scan.launches, dict(rglru_scan.paths)
    hs, hl = rglru_scan(a, b, h0)
    ps, pl = rglru_scan_plain(a, b, h0)
    assert torch.equal(hs, ps) and torch.equal(hl, pl)
    assert rglru_scan.launches == launches and rglru_scan.paths == paths
