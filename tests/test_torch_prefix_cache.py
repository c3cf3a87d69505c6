"""The port's prefix cache against the reference's: the refcounted pool
algebra and radix-tree cases of ``tests/test_prefix_cache.py`` run on the
port's own ``PagedKVPool``/``PrefixCache``, then the engine's five
scheduling modes (continuous, wave, prefix cache, chunked prefill, both)
on reduced qwen1.5-0.5b, whose greedy tokens must equal the reference
engine's in each mode, with the reference's stats identities, and the
reference's flag errors.

Weights are drawn with numpy from the reference's ``model_spec`` (the
reference's ``init_params`` is slow on this CPU) and carried to both
packages; tokens are compared exactly.
"""
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread, so the xdist workers beside it keep their cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models.params import PSpec as JPSpec  # noqa: E402
from repro.models.params import model_spec as j_model_spec  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro.serving.engine import TransformerExecutor as JExecutor  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine, TransformerExecutor  # noqa: E402
from repro_torch.serving.kvpool import NULL_PAGE, PagedKVPool  # noqa: E402
from repro_torch.serving.prefix_cache import PrefixCache  # noqa: E402

ARCH = "qwen1.5-0.5b"


# --- refcounted pool ----------------------------------------------------------

def test_shared_pages_free_only_at_refcount_zero():
    pool = PagedKVPool(num_pages=12, page_size=4, num_slots=3, pages_per_slot=4)
    pool.admit(0, initial_positions=8, max_positions=12)
    shared = list(pool.block_table[0, :2])
    pool.admit(1, initial_positions=8, max_positions=12, shared_pages=shared)
    pool.check()
    assert pool.shared_page_count() == 2
    assert all(pool.refcount[p] == 2 for p in shared)
    pool.retire(1)  # shared pages stay allocated: slot 0 still reads them
    pool.check()
    assert all(pool.refcount[p] == 1 for p in shared)
    assert pool.shared_page_count() == 0
    pool.retire(0)
    pool.check()
    assert pool.free_pages == 11


def test_shared_admission_needs_fewer_new_pages():
    pool = PagedKVPool(num_pages=6, page_size=4, num_slots=2, pages_per_slot=4)
    pool.admit(0, initial_positions=16, max_positions=16)
    shared = list(pool.block_table[0, :3])
    assert not pool.can_admit(16)
    assert pool.can_admit(16, shared=3)
    pool.admit(1, initial_positions=16, max_positions=16, shared_pages=shared)
    pool.check()
    with pytest.raises(ValueError, match="already active"):
        pool.admit(1, 4, 4)
    pool.retire(0)
    pool.retire(1)
    pool.check()


def test_pin_keeps_page_alive_across_retire():
    pool = PagedKVPool(num_pages=4, page_size=2, num_slots=1, pages_per_slot=3)
    pool.admit(0, 4, 4)
    page = int(pool.block_table[0, 0])
    pool.pin(page)
    pool.check()
    pool.retire(0)
    pool.check()
    assert pool.refcount[page] == 1 and pool.free_pages == 2
    assert pool.unpin(page)
    pool.check()
    assert pool.free_pages == 3
    with pytest.raises(ValueError):
        pool.unpin(page)


def test_release_guards():
    pool = PagedKVPool(num_pages=4, page_size=2, num_slots=2, pages_per_slot=2)
    with pytest.raises(ValueError):
        pool.pin(1)
    pool.admit(0, 2, 2)
    with pytest.raises(ValueError):
        pool.admit(1, 2, 2, shared_pages=[NULL_PAGE])
    with pytest.raises(ValueError):
        pool.admit(1, 2, 4, shared_pages=list(pool.block_table[0, :1]) * 2)


# --- radix tree ---------------------------------------------------------------

def _pool(num_pages=32, page_size=4, num_slots=4, pages_per_slot=8):
    return PagedKVPool(num_pages, page_size, num_slots, pages_per_slot)


def test_lookup_is_page_aligned_and_proper():
    pool = _pool()
    pc = PrefixCache(pool)
    prompt = list(range(10))  # 2 full pages + 2 tokens
    pool.admit(0, 12, 12)
    pc.insert(prompt, pool.block_table[0])
    assert len(pc) == 2
    pages, cached = pc.lookup(list(range(8)) + [99])
    assert cached == 8 and len(pages) == 2
    # the prompt that *is* the cached prefix keeps its last token computable
    pages, cached = pc.lookup(list(range(8)))
    assert cached == 4 and len(pages) == 1
    pages, cached = pc.lookup([0, 1, 2, 3, 9, 9, 9, 9, 5])
    assert cached == 4 and len(pages) == 1
    pc8 = PrefixCache(_pool(), grain=8)
    with pytest.raises(ValueError):
        PrefixCache(_pool(), grain=6)
    pool2 = pc8.pool
    pool2.admit(0, 12, 12)
    pc8.insert(prompt, pool2.block_table[0])
    pages, cached = pc8.lookup(list(range(8)) + [99])
    assert cached == 8 and len(pages) == 2
    pages, cached = pc8.lookup([0, 1, 2, 3, 9, 9, 9, 9, 5])
    assert cached == 0 and pages == []


def test_insert_skips_existing_nodes():
    pool = _pool()
    pc = PrefixCache(pool)
    prompt = list(range(8))
    pool.admit(0, 8, 8)
    assert pc.insert(prompt, pool.block_table[0]) == 2
    first_pages = pc.held_pages()
    pool.admit(1, 8, 8)
    assert pc.insert(prompt, pool.block_table[1]) == 0
    assert sorted(pc.held_pages()) == sorted(first_pages)
    pool.check()


def test_evict_lru_leaves_only_idle_pages():
    pool = _pool(num_pages=16)
    pc = PrefixCache(pool)
    pool.admit(0, 16, 16)
    pc.insert(list(range(16)), pool.block_table[0])
    assert len(pc) == 4
    assert pc.evict(10) == 0 and len(pc) == 4  # slot 0 reads every page
    pool.retire(0)
    pool.check()
    assert pc.evict(2) == 2 and len(pc) == 2
    assert pc.evict(10) == 2 and len(pc) == 0
    pool.check()
    assert pool.free_pages == 15
    assert pc.stats()["evicted_pages"] == 4


def test_overlapping_prefixes_share_the_common_pages():
    pool = _pool()
    pc = PrefixCache(pool)
    a = list(range(12))
    b = list(range(8)) + [50, 51, 52, 53]
    pool.admit(0, 12, 12)
    pc.insert(a, pool.block_table[0])
    pages_b, cached_b = pc.lookup(b)
    assert cached_b == 8
    pool.admit(1, 12, 12, shared_pages=pages_b)
    pc.insert(b, pool.block_table[1])
    pool.check()
    assert len(pc) == 4
    pages_a2, cached_a2 = pc.lookup(a + [99])
    assert cached_a2 == 12
    assert pages_a2[:2] == pages_b[:2]


def test_clear_unpins_everything_and_stats_count():
    pool = _pool()
    pc = PrefixCache(pool)
    pool.admit(0, 12, 12)
    pc.insert(list(range(12)), pool.block_table[0])
    pc.lookup(list(range(12)) + [1])
    pc.lookup([99] * 9)
    pool.retire(0)
    assert pc.clear() == 3 and len(pc) == 0 and pc.held_pages() == []
    pool.check()
    assert pool.free_pages == 31
    st = pc.stats()
    assert (st["lookups"], st["hits"], st["hit_tokens"], st["inserted_pages"],
            st["evicted_pages"], st["nodes"], st["hit_rate"]) == (2, 1, 12, 3, 3, 0, 0.5)


def test_random_prefix_lifecycle_never_leaks_or_double_frees():
    hypothesis = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hypothesis.settings(max_examples=50, deadline=None)
    @hypothesis.given(
        ops=st.lists(
            st.tuples(st.sampled_from(["admit", "grow", "retire", "evict"]),
                      st.integers(0, 3), st.integers(0, 2), st.integers(0, 20)),
            max_size=50),
        page_size=st.integers(1, 4),
        num_pages=st.integers(4, 40),
    )
    def run(ops, page_size, num_pages):
        pool = PagedKVPool(num_pages, page_size, num_slots=4, pages_per_slot=8)
        pc = PrefixCache(pool)
        bases = [[100 + f] * 32 for f in range(3)]
        live = {}
        for op, slot, fam, arg in ops:
            if op == "admit" and not pool.active[slot]:
                prompt = bases[fam][: max(arg, 1)] + [slot, fam, arg]
                s = len(prompt)
                s_pad = -(-s // page_size) * page_size
                maxp = s_pad + 1 + arg % 3
                if pool.pages_for(maxp) > pool.pages_per_slot:
                    continue
                pages, _ = pc.lookup(prompt)
                if not pool.can_admit(maxp, shared=len(pages)):
                    pc.evict(pool.pages_for(maxp) - len(pages) - pool.available)
                    pages, _ = pc.lookup(prompt)
                    if not pool.can_admit(maxp, shared=len(pages)):
                        continue
                pool.admit(slot, initial_positions=s_pad, max_positions=maxp,
                           shared_pages=pages)
                pc.insert(prompt, pool.block_table[slot])
                live[slot] = (s, maxp)
            elif op == "grow" and pool.active[slot]:
                s, maxp = live[slot]
                pool.ensure(slot, min(s + arg % 4, maxp - 1))
            elif op == "retire" and pool.active[slot]:
                pool.retire(slot)
                live.pop(slot)
            elif op == "evict":
                pc.evict(arg)
            pool.check()
        for slot in list(live):
            pool.retire(slot)
            pool.check()
        pc.clear()
        pool.check()
        assert pool.free_pages == num_pages - 1

    run()


# --- engine: the five modes against the reference engine ----------------------

_SYS = [7, 7, 7] + list(range(50, 79))  # 32 tokens: 4 pages at page_size 8
MODES = {
    "continuous": dict(scheduler="continuous"),
    "wave": dict(scheduler="wave"),
    "prefix": dict(scheduler="continuous", prefix_cache=True),
    "chunked": dict(scheduler="continuous", prefill_chunk=8),
    "both": dict(scheduler="continuous", prefix_cache=True, prefill_chunk=8),
}


def _prompts():
    rng = np.random.default_rng(0)
    return [(_SYS + [int(t) for t in rng.integers(1, 300, 5 + i)], 6 if i % 2 else 12)
            for i in range(6)]


def _numpy_params(jcfg, seed=0):
    """The reference's parameter tree drawn with numpy: matrices at 4x the
    init scale and norm scales and biases nonzero, so greedy tokens vary."""
    rng = np.random.default_rng(seed)

    def make(path, ps):
        grouped = getattr(path[0], "key", None) == "groups"
        shape = ((jcfg.num_groups,) if grouped else ()) + ps.shape
        if ps.init in ("zeros", "ones"):
            base = 1.0 if ps.init == "ones" else 0.0
            return (base + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = min(ps.scale, 1.0 / np.sqrt(fan_in))
        boost = 1.0 if path[-1].key == "tok" else 4.0
        return (rng.standard_normal(shape) * scale * boost).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        make, j_model_spec(jcfg), is_leaf=lambda x: isinstance(x, JPSpec))


@pytest.fixture(scope="module")
def served():
    """Every mode served by both engines (the reference's executor shared
    across its modes, so each shape is compiled once)."""
    jcfg, cfg = j_reduced(j_get_config(ARCH)), reduced(get_config(ARCH))
    tree = _numpy_params(jcfg)
    jex = JExecutor(jax.tree.map(jnp.asarray, tree), jcfg)
    ex = TransformerExecutor(params_from_numpy(tree), cfg)
    out = {}
    for mode, kw in MODES.items():
        engines = (JEngine(executor=jex, max_batch=3, max_len=64, page_size=8, **kw),
                   ServingEngine(ex, max_batch=3, max_len=64, page_size=8, **kw))
        for eng, req in zip(engines, (JRequest, Request)):
            for i, (p, n) in enumerate(_prompts()):
                eng.submit(req(uid=i, prompt=p, max_new_tokens=n))
        jdone, done = (e.run() for e in engines)
        out[mode] = ({r.uid: r.output for r in jdone}, {r.uid: r.output for r in done},
                     engines[0], engines[1])
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_greedy_tokens_match_reference_engine(served, mode):
    want, got, jeng, eng = served[mode]
    assert got == want
    assert all(len(got[i]) == n for i, (_, n) in enumerate(_prompts()))
    assert got == served["continuous"][1]  # every mode serves the same tokens
    for key in ("prefill_tokens", "decode_steps", "decode_tokens", "prefill_chunks",
                "prefix_hits", "cached_prefix_tokens", "peak_shared_pages"):
        assert eng.stats[key] == jeng.stats[key], key


def test_tokens_vary(served):
    got = served["continuous"][1]
    assert len({t for o in got.values() for t in o}) > 6


def test_prefix_and_chunk_stats_identities(served):
    """Suffix-only prefill (computed == prompt - cached), at least one page
    shared across concurrent slots, chunking that really chunked, and the
    prefix tree's stats beside the reference's."""
    total = sum(len(p) for p, _ in _prompts())
    s0 = served["continuous"][3].stats
    _, _, jeng1, eng1 = served["prefix"]
    s1 = eng1.stats
    assert s0["prefill_tokens"] == total and s0["prefill_oneshots"] == 6
    assert s1["cached_prefix_tokens"] > 0
    assert s1["prefill_tokens"] + s1["cached_prefix_tokens"] == total
    assert s1["peak_shared_pages"] >= 1 and s1["prefix_hits"] >= 1
    eng1.pool.check()
    assert served["chunked"][3].stats["prefill_chunks"] > len(_prompts())
    assert served["both"][3].stats["prefill_chunks"] > 0
    for mode in ("prefix", "both"):
        _, _, jeng, eng = served[mode]
        assert eng.prefix_stats == jeng.prefix_stats
        assert eng.prefix_stats["hits"] >= 1
    assert served["continuous"][3].prefix_stats is None


def test_prefix_flags_need_capable_executor_and_scheduler(served):
    ex = served["continuous"][3].executor
    eng = ServingEngine(ex, scheduler="wave", prefix_cache=True)
    eng.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=2))
    with pytest.raises(ValueError, match="continuous"):
        eng.run()
    with pytest.raises(ValueError, match="prefill_chunk"):
        ServingEngine(ex, prefill_chunk=0)

    class NoChunk:
        supports_paged = True

    with pytest.raises(ValueError, match="prefill_chunk"):
        ServingEngine(NoChunk(), prefix_cache=True)
