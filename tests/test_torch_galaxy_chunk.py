"""The Galaxy executor's chunked prefill at an offset against the reference:
the context attention against the reference's ``_ctx_attention`` on the
same inputs; ``prefill_chunk`` logits at every chunk row against the
reference's full-context ``reference_stack`` logits, on the uneven 3:2:2:1
plan and both backends; and a copy of ``tests/test_execplan.py``'s
``test_prefix_cache_serving_acceptance`` on ``LocalRing(4)``: base, wave,
prefix cache, chunks of 8 and both give equal greedy tokens, equal to the
reference's full-context greedy loop, with the suffix-only prefill
identities and ``pool.check()``.

Tolerance: fp32, 1e-4 on logits through 2 layers and the tied unembedding
(PyTorch's and XLA's CPU matmuls sum in different orders; the chunk's
context part adds a concatenation, not a new order of the valid terms).
"""
import functools

import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread, so the xdist workers beside it keep their cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import hmp as jhmp  # noqa: E402
from repro.core.execplan import ExecPlan as JExecPlan  # noqa: E402
from repro_torch.core import hmp  # noqa: E402
from repro_torch.core.execplan import ExecPlan  # noqa: E402
from repro_torch.core.ring import LocalRing  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.galaxy import GalaxyHMPExecutor  # noqa: E402

SHARES = dict(heads=(6, 4, 4, 2), columns=(24, 16, 16, 8), head_dim=2, d_model=32,
              seq_shares=(3.0, 2.0, 2.0, 1.0))
PLAN = ExecPlan(**SHARES)
JPLAN = JExecPlan(**SHARES)


# --- the context attention ------------------------------------------------------

@pytest.mark.parametrize("offset", [0, 5, 16, 24])
@pytest.mark.parametrize("s", [8, 5, 1])
def test_ctx_attention_matches_reference(s, offset):
    """The chunk's attention over gathered context rows [0, 24) and its own
    K/V, ragged (a plan layout) and dense, against the reference's pure-jnp
    ``_ctx_attention`` on the same numbers."""
    rng = np.random.default_rng(s * 100 + offset)
    for layout_j, layout in ((JPLAN.seq_layout(s), PLAN.seq_layout(s)), (None, None)):
        rows = s if layout is None else layout.padded_len
        q, k, v = (rng.normal(size=(1, rows, 3, 4)).astype(np.float32) for _ in range(3))
        ck, cv = (rng.normal(size=(24, 3, 4)).astype(np.float32) for _ in range(2))
        jl = None if layout_j is None or layout_j.is_dense else layout_j
        pl = None if layout is None or layout.is_dense else layout
        want = np.asarray(jhmp._ctx_attention(*map(jnp.asarray, (q, k, v)),
                                              (jnp.asarray(ck), jnp.asarray(cv), offset), jl))
        t = [torch.from_numpy(a) for a in (q, k, v, ck, cv)]
        got = hmp._ctx_attention(*t[:3], t[3], t[4], offset, hmp._local_mask(pl, rows, "cpu"))
        valid = np.ones(rows, bool) if pl is None else pl.valid
        np.testing.assert_allclose(got.numpy()[:, valid], want[:, valid], atol=1e-6, rtol=0)
        # gathering only the pages below the offset changes nothing: the
        # masked context rows contribute exact zeros
        short = hmp._ctx_attention(*t[:3], t[3][:offset], t[4][:offset], offset,
                                   hmp._local_mask(pl, rows, "cpu"))
        np.testing.assert_allclose(short.numpy()[:, valid], got.numpy()[:, valid],
                                   atol=1e-6, rtol=0)


# --- prefill_chunk logits at every row ---------------------------------------------

@functools.lru_cache(maxsize=None)
def _stack():
    """2 layers at d 32 (16 heads of 2, d_ff 64), vocab 50, and a 24-token
    prompt's full-context reference logits."""
    layers = jhmp.init_stack_params(jax.random.PRNGKey(0), 2, 32, 16, 64)
    emb = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (50, 32))) * 0.5
    tokens = np.random.default_rng(3).integers(1, 50, (1, 24))
    ref = np.asarray(jax.jit(jhmp.reference_stack)(layers, jnp.asarray(emb)[tokens]) @ emb.T)
    return layers, emb, tokens, ref


def _executor(backend):
    layers, emb, _, _ = _stack()
    lt, et = hmp.params_from_numpy(layers, emb)
    return GalaxyHMPExecutor(lt, et, PLAN.with_backend(backend), LocalRing(4))


# (offset, rows) of consecutive chunks of one prompt: grain-aligned chunks
# of 8 at offsets 0, 8, 16; then verify-shaped chunks (5, 1 and 2 rows,
# whose ragged layouts leave devices a tile of 0-2 rows)
CHUNKINGS = {"grain": ((0, 8), (8, 8), (16, 8)),
             "verify": ((0, 8), (8, 8), (16, 5), (21, 1), (22, 2))}


@pytest.mark.parametrize("chunking", list(CHUNKINGS))
@pytest.mark.parametrize("backend", ["eager", "kernel"])
def test_prefill_chunk_logits_match_reference_stack(backend, chunking):
    _, _, tokens, ref = _stack()
    ex = _executor(backend)
    pool = ex.make_pool(9, 8)
    row = np.array([3, 1, 7, 5, 0, 0])  # scattered physical pages
    for off, n in CHUNKINGS[chunking]:
        logits, pool = ex.prefill_chunk(tokens[:, off:off + n], pool, row, offset=off,
                                        length=24)
        assert logits.shape == (1, n, 50)
        np.testing.assert_allclose(logits.numpy(), ref[:, off:off + n], atol=1e-4, rtol=0)


def test_chunked_pages_equal_one_shot_prefill():
    """The pages the chunks write hold the one-shot prefill's K/V at every
    valid position and head slot (the gather ran before the scatter, so no
    chunk key was counted twice)."""
    _, _, tokens, _ = _stack()
    ex = _executor("kernel")
    row = np.array([3, 1, 7, 0, 0, 0])
    one = ex.make_pool(9, 8)
    _, one = ex.prefill_paged(tokens, one, row, length=24)
    chunked = ex.make_pool(9, 8)
    for off in (0, 8, 16):
        _, chunked = ex.prefill_chunk(tokens[:, off:off + 8], chunked, row, offset=off,
                                      length=24)
    for a, b in zip(one, chunked):
        for kind in ("k", "v"):
            for i, (x, y) in enumerate(zip(a[kind], b[kind])):
                h = PLAN.heads[i]
                torch.testing.assert_close(y[row[:3], :, :h], x[row[:3], :, :h],
                                           atol=1e-5, rtol=0)


def test_offset_needs_a_paged_cache():
    ex = _executor("eager")
    x = torch.zeros(1, 8, 32)
    with pytest.raises(ValueError, match="paged cache"):
        hmp.hmp_prefill(ex.layers, x, ex.ring, ex.make_cache(1, 8), plan=ex.plan,
                        seq=8, offset=8)
    with pytest.raises(ValueError, match="exceed the block row"):
        ex.prefill_chunk(np.ones((1, 8), np.int64), ex.make_pool(3, 8), [1, 2],
                         offset=16, length=24)


# --- the prefix-cache serving acceptance of tests/test_execplan.py ------------------

@functools.lru_cache(maxsize=None)
def _serving_case():
    """4 prompts behind a 16-token shared system prompt (2 pages) and their
    full-context greedy tokens (jitted once on a padded length)."""
    layers, emb, _, _ = _stack()
    sysp = list(range(1, 17))
    prompts = [sysp + [20 + i, 21, 22 + i, 23] for i in range(4)]

    @jax.jit
    def logits(tokens):
        return jhmp.reference_stack(layers, jnp.asarray(emb)[tokens]) @ emb.T

    want = {}
    for uid, pr in enumerate(prompts):
        toks = list(pr)
        for _ in range(3 + uid):
            padded = np.zeros((1, 32), np.int32)
            padded[0, :len(toks)] = toks
            toks.append(int(np.argmax(np.asarray(logits(padded))[0, len(toks) - 1])))
        want[uid] = toks[len(pr):]
    return prompts, want


MODES = {
    "base": dict(scheduler="continuous"),
    "wave": dict(scheduler="wave"),
    "prefix": dict(scheduler="continuous", prefix_cache=True),
    "chunked": dict(scheduler="continuous", prefill_chunk=8),
    "both": dict(scheduler="continuous", prefix_cache=True, prefill_chunk=8),
}


@pytest.mark.parametrize("backend", ["eager", "kernel"])
def test_prefix_cache_serving_acceptance(backend):
    """Greedy tokens with the shared-prefix cache on == off == chunked ==
    wave == full-context reference, on the uneven 3:2:2:1 plan, with
    suffix-only prefill (computed == prompt - cached), at least one page
    shared across concurrent slots, and the pool's refcount algebra
    checked."""
    prompts, want = _serving_case()
    ex = _executor(backend)
    out, engines = {}, {}
    for mode, kw in MODES.items():
        eng = ServingEngine(ex, max_batch=3, max_len=40, page_size=8, **kw)
        for i, pr in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=list(pr), max_new_tokens=3 + i))
        out[mode] = {r.uid: r.output for r in eng.run()}
        engines[mode] = eng
    for mode in MODES:
        assert out[mode] == want, mode
    total = sum(len(p) for p in prompts)
    s1 = engines["prefix"].stats
    assert s1["cached_prefix_tokens"] > 0 and s1["prefix_hits"] >= 1
    assert s1["prefill_tokens"] + s1["cached_prefix_tokens"] == total
    assert s1["peak_shared_pages"] >= 1, s1
    assert engines["chunked"].stats["prefill_chunks"] >= len(prompts)
    assert engines["both"].stats["prefill_chunks"] > 0
    assert engines["base"].stats["prefill_oneshots"] == len(prompts)
    assert engines["wave"].stats["prefill_waves"] >= 1
    for mode in ("base", "prefix", "chunked", "both"):
        engines[mode].pool.check()
    # without the prefix tree's pins every page comes back
    for mode in ("base", "chunked"):
        assert engines[mode].pool.free_pages == engines[mode].pool.num_pages - 1
