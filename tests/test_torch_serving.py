"""The port's serving layer: the paged KV pool (against the reference's
pool on the same operations), the sampler, and continuous batching whose
greedy tokens equal the reference's full-context greedy loop.

Tokens are compared exactly: greedy argmax over fp32 logits that agree to
~1e-5 (see test_torch_hmp.py), on inputs whose top-2 logit gap is far
wider.  Sampled tokens are not compared across packages (``jax.random``
has no PyTorch twin).
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
from repro.serving.kvpool import PagedKVPool as JPool  # noqa: E402
from repro_torch.core import hmp  # noqa: E402
from repro_torch.core.execplan import ExecPlan  # noqa: E402
from repro_torch.core.ring import LocalRing  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.galaxy import GalaxyHMPExecutor  # noqa: E402
from repro_torch.serving.kvpool import NULL_PAGE, PagedKVPool, PoolExhausted  # noqa: E402
from repro_torch.serving.sampler import SamplerConfig, sample  # noqa: E402

PLAN = ExecPlan(heads=(6, 4, 4, 2), columns=(24, 16, 16, 8), head_dim=2,
                d_model=32, seq_shares=(3.0, 2.0, 2.0, 1.0))
PROMPTS = [[1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], [4, 7, 1, 9, 2, 8, 3, 6, 5, 10, 12],
           [3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8]]


def test_pool_lifecycle_and_check():
    pool = PagedKVPool(num_pages=9, page_size=4, num_slots=2, pages_per_slot=4)
    assert pool.free_pages == 8  # page 0 is the null page
    pool.admit(0, initial_positions=5, max_positions=13)
    pool.check()
    assert pool.free_pages == 6 and pool.available == 4
    pool.ensure(0, 8)  # crosses into a third page
    assert pool.free_pages == 5
    assert not pool.can_admit(20)
    pool.ensure(0, 15)  # the fourth and last reserved page
    with pytest.raises(PoolExhausted):
        pool.ensure(0, 16)  # beyond its reservation
    pool.admit(1, 4, 4, shared_pages=[int(pool.block_table[0, 0])])
    pool.pin(int(pool.block_table[0, 1]))
    pool.check()
    assert pool.shared_page_count() == 1
    pages = pool.retire(0)
    pool.check()
    assert len(pages) == 4 and np.all(pool.block_table[0] == NULL_PAGE)
    pool.retire(1)
    assert pool.unpin(int(pages[1]))  # last reference: freed
    pool.check()
    assert pool.free_pages == 8
    pool._free.append(pool._free[0])  # a double free is caught
    with pytest.raises(AssertionError, match="duplicate"):
        pool.check()


def test_pool_matches_reference_on_an_op_sequence():
    rng = np.random.default_rng(0)
    a = PagedKVPool(num_pages=12, page_size=3, num_slots=3, pages_per_slot=5)
    b = JPool(num_pages=12, page_size=3, num_slots=3, pages_per_slot=5)
    pos = [0, 0, 0]
    for _ in range(200):
        slot = int(rng.integers(3))
        op = rng.choice(["admit", "ensure", "retire", "truncate"])
        if op == "admit" and not a.active[slot]:
            init = int(rng.integers(1, 8))
            mx = init + int(rng.integers(0, 7))
            assert a.can_admit(mx) == b.can_admit(mx)
            if a.can_admit(mx):
                a.admit(slot, init, mx)
                b.admit(slot, init, mx)
                pos[slot] = init
        elif a.active[slot] and op == "ensure":
            p = pos[slot] + int(rng.integers(0, 3))
            if p < a._reserved[slot] * 3:
                a.ensure(slot, p)
                b.ensure(slot, p)
                pos[slot] = p
        elif a.active[slot] and op == "truncate":
            assert a.truncate(slot, pos[slot]) == b.truncate(slot, pos[slot])
        elif a.active[slot] and op == "retire":
            assert a.retire(slot) == b.retire(slot)
        a.check()
        np.testing.assert_array_equal(a.block_table, b.block_table)
        assert a.available == b.available and a.free_pages == b.free_pages


def test_sampler_greedy_and_seeded():
    logits = torch.tensor([[0.1, 3.0, -1.0, 2.9], [5.0, 0.0, 0.0, 0.0]])
    gen = torch.Generator().manual_seed(0)
    assert sample(logits, gen, SamplerConfig()).tolist() == [1, 0]
    cfg = SamplerConfig(temperature=1.0, top_k=2)
    draws = [sample(logits, torch.Generator().manual_seed(5), cfg) for _ in range(2)]
    assert torch.equal(draws[0], draws[1])  # reproducible from the seed
    many = torch.cat([sample(logits, gen, cfg) for _ in range(64)])
    assert set(many.tolist()) <= {0, 1, 3}  # top-2 support per row


@functools.lru_cache(maxsize=None)
def _reference_tokens():
    """Full-context greedy loop over the reference stack (jitted once on a
    right-padded length; causal, so each row's logits are exact)."""
    layers = jhmp.init_stack_params(jax.random.PRNGKey(0), 3, 32, 16, 64)
    emb = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (50, 32))) * 0.5

    @jax.jit
    def logits(tokens):
        return jhmp.reference_stack(layers, jnp.asarray(emb)[tokens]) @ emb.T

    out = []
    for uid, pr in enumerate(PROMPTS):
        toks = list(pr)
        for _ in range(3 + uid):
            padded = np.zeros((1, 24), np.int32)
            padded[0, :len(toks)] = toks
            toks.append(int(np.argmax(np.asarray(logits(padded))[0, len(toks) - 1])))
        out.append(toks[len(pr):])
    return layers, emb, out


@pytest.mark.parametrize("backend", ["kernel", "eager"])
def test_continuous_batching_matches_reference_greedy(backend):
    """max_batch=3 over 4 requests: a slot retires and its pages are reused
    by the queued request; greedy tokens equal the reference for every
    request."""
    layers, emb, expected = _reference_tokens()
    lt, et = hmp.params_from_numpy(layers, emb)
    exe = GalaxyHMPExecutor(lt, et, PLAN.with_backend(backend), LocalRing(4))
    eng = ServingEngine(exe, max_batch=3, max_len=24, page_size=8)
    for i, pr in enumerate(PROMPTS):
        eng.submit(Request(uid=i, prompt=list(pr), max_new_tokens=3 + i))
    done = {r.uid: r.output for r in eng.run()}
    assert [done[i] for i in range(len(PROMPTS))] == expected
    eng.pool.check()
    assert eng.pool.free_pages == eng.pool.num_pages - 1  # every page returned
    assert eng.stats["requests"] == 4
    assert eng.stats["prefill_tokens"] == sum(len(p) for p in PROMPTS)
    assert eng.stats["decode_tokens"] == sum(2 + i for i in range(4))


def test_engine_budget_eos_and_pool_limits():
    """A prompt that fills ``max_len`` retires with no output, an EOS token
    ends a request early, and a pool too small for the head request
    raises instead of spinning."""
    layers, emb, expected = _reference_tokens()
    lt, et = hmp.params_from_numpy(layers, emb)
    exe = GalaxyHMPExecutor(lt, et, PLAN, LocalRing(4))
    eng = ServingEngine(exe, max_batch=2, max_len=24, page_size=8)
    eng.submit(Request(uid=0, prompt=list(range(1, 25)), max_new_tokens=4))
    eng.submit(Request(uid=1, prompt=list(PROMPTS[0]), max_new_tokens=5,
                       eos_id=expected[0][0]))
    done = {r.uid: r for r in eng.run()}
    assert done[0].done and done[0].output == []
    assert done[1].output == expected[0][:1]
    small = ServingEngine(exe, max_batch=2, max_len=24, page_size=8, num_pages=2)
    small.submit(Request(uid=0, prompt=list(PROMPTS[0]), max_new_tokens=8))
    with pytest.raises(RuntimeError, match="cannot fit the pool"):
        small.run()


def test_serve_compute_backend_flag_on_cpu(capsys):
    """``launch.serve --compute-backend {kernel,eager}`` reaches the Galaxy
    plan (``ExecPlan.compute_backend``), as the reference's flag does; the
    two backends serve the same greedy tokens (fp32 on the CPU, where the
    kernel wrappers run their plain versions); the zoo refuses the flag."""
    from repro_torch.launch import serve as launch_serve

    kw = dict(requests=2, prompt_len=(8, 12), max_new=3, device="cpu", reduce=True,
              dtype="float32")
    outs = {b: launch_serve.serve("distilbert", (2, 1), compute_backend=b, **kw)
            for b in ("kernel", "eager")}
    assert "backend=eager" in outs["eager"]["plan"]
    assert "backend=kernel" in outs["kernel"]["plan"]
    assert [r.output for r in outs["kernel"]["requests"]] == \
        [r.output for r in outs["eager"]["requests"]]
    launch_serve.main(["--model", "distilbert", "--capacities", "2,1", "--reduce",
                       "--device", "cpu", "--dtype", "float32", "--requests", "1",
                       "--prompt-len", "8-12", "--max-new", "2",
                       "--compute-backend", "eager"])
    assert "backend=eager" in capsys.readouterr().out
    with pytest.raises(ValueError, match="Galaxy"):
        launch_serve.serve("qwen1.5-0.5b", executor_kind="zoo", compute_backend="eager", **kw)
