"""The one-shot paged prefill as a step on device inputs (``prefill_paged``
of both executors), its captured graphs, and the held paged pool those
graphs outlive engine runs on (``serving/graphs.py``), on the CPU.

What the CPU can hold of a captured one-shot prefill:

* the prefill step (``_prefill_paged_step``: tokens, block row and the
  logits row ``length - 1`` on the device) reads no tensor value on the
  host, sizes no output by its data and builds no tensor from host data
  once a shape has been warmed up (a ``TorchDispatchMode``): the uneven
  4-device Galaxy plan on ``LocalRing`` (both backends), reduced
  qwen1.5-0.5b and StableLM-12B;
* the same step against the reference: the zoo's against the reference
  executor's ``prefill_paged`` (JAX, CPU, jitted once a padded length),
  logits and the pages it wrote; the Galaxy's on a one-device plan
  against the reference executor's on a one-device mesh, logits and
  pages; on the uneven 4-device plan against the reference's
  full-context ``reference_stack`` logits;
* the device row gives the host-int row's logits and pages bitwise;
* with graphs on, ``make_pool`` hands back the held pool, zeroed in place
  and bitwise a fresh one after a dirty run; another geometry lets it go
  with its graphs; a pool the executor does not hold runs eagerly;
* ``StepGraph``'s bookkeeping through a stand-in runtime whose replay
  re-runs the captured closure: ``"prefill"`` captured on a shape's second
  call, one capture serving two lengths; a pool not held refused, a
  draft's pool held apart from the target's at the same geometry, each
  with its own graphs; the paged graphs survive a second and third engine
  run, which capture nothing new; an executor that drafts for itself with
  the prefix cache gives the tokens and stats of graphs off;
  ``launch.serve.serve`` on a taken executor keeps the graphs, and a
  Galaxy serve with a draft gives the tokens of graphs off.

Tolerance: fp32, 1e-4 on logits and pages (PyTorch's and XLA's CPU
matmuls sum in different orders).  The bitwise comparisons of graphs on
and off on the card are ``cuda``-marked in ``tests/test_torch_cuda.py``.
"""
import copy
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.core import hmp as jhmp  # noqa: E402
from repro.core.execplan import ExecPlan as JExecPlan  # noqa: E402
from repro.launch.mesh import make_mesh_compat  # noqa: E402
from repro.serving.engine import TransformerExecutor as JExecutor  # noqa: E402
from repro.serving.galaxy import GalaxyHMPExecutor as JGalaxy  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import hmp  # noqa: E402
from repro_torch.core.execplan import ExecPlan  # noqa: E402
from repro_torch.core.ring import LocalRing  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving import graphs  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine, TransformerExecutor  # noqa: E402
from repro_torch.serving.galaxy import GalaxyHMPExecutor  # noqa: E402
from torch_helpers import NoHostReads, StandInRuntime, numpy_params  # noqa: E402

TOL = dict(atol=1e-4, rtol=0)
PAGE, PAGES = 8, 7
ROW = np.array([5, 2, 3])  # 3 pages of 8: a 16-token prompt fills the first two
S, LENGTHS = 16, (13, 9)  # a prompt padded to 16, at two real lengths


# --- the executors -----------------------------------------------------------------------

SHARES = dict(heads=(6, 4, 4, 2), columns=(24, 16, 16, 8), head_dim=2, d_model=32,
              seq_shares=(3.0, 2.0, 2.0, 1.0))
ONE = dict(heads=(16,), columns=(64,), head_dim=2, d_model=32)


@functools.lru_cache(maxsize=None)
def _galaxy_stack():
    """2 reference-layout layers drawn with numpy at d 32 (16 heads of 2,
    d_ff 64), vocab 50; a prompt of 16 tokens and its full-context
    reference logits (causal: row p is what a prefill of p + 1 tokens
    gives)."""
    rng = np.random.default_rng(0)

    def draw(*shape, scale=1.0, base=0.0):
        return (base + scale * rng.standard_normal(shape)).astype(np.float32)

    layers = [{"wq": draw(32, 16, 2, scale=0.2), "wk": draw(32, 16, 2, scale=0.2),
               "wv": draw(32, 16, 2, scale=0.2), "wo": draw(16, 2, 32, scale=0.2),
               "w1": draw(32, 64, scale=0.2), "w2": draw(64, 32, scale=0.1),
               "ln1_s": draw(32, scale=0.1, base=1.0), "ln1_b": draw(32, scale=0.1),
               "ln2_s": draw(32, scale=0.1, base=1.0), "ln2_b": draw(32, scale=0.1)}
              for _ in range(2)]
    emb = draw(50, 32, scale=0.5)
    tokens = rng.integers(1, 50, (1, S))
    ref = np.asarray(jax.jit(jhmp.reference_stack)(layers, jnp.asarray(emb)[tokens]) @ emb.T)
    return layers, emb, tokens, ref[0]


def _galaxy(shares=SHARES, ring=None, backend="kernel"):
    layers, emb, _, _ = _galaxy_stack()
    lt, et = hmp.params_from_numpy(layers, emb)
    return GalaxyHMPExecutor(lt, et, ExecPlan(**shares).with_backend(backend),
                             ring or LocalRing(4))


@functools.lru_cache(maxsize=None)
def _zoo_pair(arch):
    jcfg, cfg = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    if arch == "stablelm-12b":  # keep GQA under test
        jcfg = dataclasses.replace(jcfg, num_kv_heads=2)
        cfg = dataclasses.replace(cfg, num_kv_heads=2)
    tree = numpy_params(jcfg)
    return (TransformerExecutor(params_from_numpy(tree), cfg),
            JExecutor(jax.tree.map(jnp.asarray, tree), jcfg))


def _zoo(arch="qwen1.5-0.5b"):
    """A copy of the cached zoo executor (graphs set on it stay there)."""
    return copy.copy(_zoo_pair(arch)[0])


def _tokens(vocab):
    return np.random.default_rng(5).integers(1, vocab, (1, S))


def _warmed_step(ex, tokens):
    """The prefill step warmed up on a scratch pool (a graph's first,
    eager call), then the step and its device inputs at each length."""
    tok, row = torch.as_tensor(tokens), torch.as_tensor(ROW)
    ex._prefill_paged_step(ex.make_pool(PAGES, PAGE), tok, row, torch.tensor([S - 1]))
    return [(n, tok, row, torch.tensor([n - 1])) for n in LENGTHS]


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(graphs.leaves(a), graphs.leaves(b)))


# --- the Galaxy step ----------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["kernel", "eager"])
def test_galaxy_prefill_step_reads_nothing_and_matches_full_context(backend):
    """The uneven 4-device plan on ``LocalRing``: the logits of a 16-row
    prompt at real lengths 13 and 9 are the full-context reference's at
    the last real token."""
    _, _, tokens, ref = _galaxy_stack()
    ex = _galaxy(backend=backend)
    for n, tok, row, last in _warmed_step(ex, tokens):
        pool = ex.make_pool(PAGES, PAGE)
        with NoHostReads(host_data=True):
            logits = ex._prefill_paged_step(pool, tok, row, last)
        assert logits.shape == (1, 50)
        np.testing.assert_allclose(logits.numpy()[0], ref[n - 1], **TOL)


def test_galaxy_prefill_matches_reference_executor():
    """A one-device plan against the reference executor's ``prefill_paged``
    on a one-device mesh: logits and every layer's pages."""
    layers, emb, tokens, _ = _galaxy_stack()
    ex = _galaxy(ONE, LocalRing(1))
    jex = JGalaxy(jax.tree.map(jnp.asarray, layers), jnp.asarray(emb), JExecPlan(**ONE),
                  make_mesh_compat((1,), ("model",)))
    for n in LENGTHS:
        pool, jpool = ex.make_pool(PAGES, PAGE), jex.make_pool(PAGES, PAGE)
        got, pool = ex.prefill_paged(tokens, pool, ROW, length=n)
        want, jpool = jex.prefill_paged(jnp.asarray(tokens, jnp.int32), jpool,
                                        jnp.asarray(ROW, jnp.int32), n)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for layer, jlayer in zip(pool, jpool):
            for name in ("k", "v"):
                np.testing.assert_allclose(layer[name][0].numpy(), np.asarray(jlayer[name]),
                                           **TOL)


# --- the zoo's step -------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "stablelm-12b"])
def test_zoo_prefill_step_reads_nothing_and_matches_reference(arch):
    """The step under the dispatch mode against the reference executor's
    ``prefill_paged`` at both lengths: logits and every pool leaf."""
    ex, jex = _zoo_pair(arch)
    for n, tok, row, last in _warmed_step(ex, _tokens(ex.cfg.vocab_size)):
        pool, jpool = ex.make_pool(PAGES, PAGE), jex.make_pool(PAGES, PAGE)
        with NoHostReads(host_data=True):
            logits = ex._prefill_paged_step(pool, tok, row, last)
        want, jpool = jex.prefill_paged(jnp.asarray(tok.numpy(), jnp.int32), jpool,
                                        jnp.asarray(ROW, jnp.int32), n)
        np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)
        for part, blocks in pool.items():
            for key, leaves in blocks.items():
                for name, leaf in leaves.items():
                    np.testing.assert_allclose(leaf.numpy(),
                                               np.asarray(jpool[part][key][name]), **TOL)


# --- the device row against the host int ------------------------------------------------------

@pytest.mark.parametrize("executor", ["galaxy", "zoo"])
def test_device_row_is_bitwise_the_host_int_row(executor):
    """``prefill_paged`` (the row a (1,) device tensor) against the
    host-int row the call took before it became a step: the Galaxy's
    ``y[:, length - 1]``, the zoo's ``rows=length - 1``; logits and every
    page bitwise."""
    ex = _galaxy() if executor == "galaxy" else _zoo()
    vocab = ex.embed.shape[0] if executor == "galaxy" else ex.cfg.vocab_size
    tokens = _tokens(vocab)
    tok, row = torch.as_tensor(tokens), torch.as_tensor(ROW)
    for n in LENGTHS:
        pool, host = ex.make_pool(PAGES, PAGE), ex.make_pool(PAGES, PAGE)
        got, _ = ex.prefill_paged(tokens, pool, ROW, length=n)
        if executor == "galaxy":
            layout, x = ex._embed(tok)
            y, _ = hmp.hmp_prefill(ex.layers, x, ex.ring, host, plan=ex.plan, overlap=True,
                                   seq=S, block_row=row)
            want = layout.gather(y)[:, n - 1] @ ex.embed.T
        else:
            want = ex._prefill_paged_step(host, tok, row, n - 1)
        assert torch.equal(got, want) and _equal(pool, host), n


# --- the held pool ------------------------------------------------------------------------------

@pytest.mark.parametrize("executor", ["galaxy", "zoo"])
def test_held_pool_is_zeroed_in_place_and_let_go_for_another_geometry(executor):
    """Without graphs each ``make_pool`` is a new pool.  With them the
    held pool comes back at the same storage after a dirty run (its graph
    captured, every entry non-finite), bitwise a fresh pool, its graph
    replayed; a pool of another geometry is a new one, and its first
    prefill runs eagerly again (the old pool's graphs went)."""
    ex = _galaxy() if executor == "galaxy" else _zoo()
    eager = copy.copy(ex)
    vocab = ex.embed.shape[0] if executor == "galaxy" else ex.cfg.vocab_size
    tokens = _tokens(vocab)
    assert ex.make_pool(PAGES, PAGE) is not ex.make_pool(PAGES, PAGE)
    assert ex.graph_stats is None
    ex._graph = graphs.StepGraph("cpu", runtime=StandInRuntime())
    pool = ex.make_pool(PAGES, PAGE)
    where = graphs.storage(pool)
    for n in LENGTHS:
        ex.prefill_paged(tokens, pool, ROW, length=n)
    for t in graphs.leaves(pool):
        t.fill_(float("nan"))
    again = ex.make_pool(PAGES, PAGE)
    assert again is pool and graphs.storage(again) == where
    assert _equal(again, eager.make_pool(PAGES, PAGE))
    assert ex.graph_stats["paged_pool"] == {
        "pools": 1, "bytes": sum(t.numel() * 4 for t in graphs.leaves(pool))}
    got, _ = ex.prefill_paged(tokens, again, ROW, length=LENGTHS[0])
    want, _ = eager.prefill_paged(tokens, eager.make_pool(PAGES, PAGE), ROW,
                                  length=LENGTHS[0])
    assert torch.equal(got, want)
    stats = ex.graph_stats["prefill"]
    assert (stats["captures"], stats["replays"]) == (1, 2)
    other = ex.make_pool(PAGES + 2, PAGE)
    assert other is not pool and ex.graph_stats["paged_pool"]["pools"] == 1
    ex.prefill_paged(tokens, other, ROW, length=LENGTHS[0])  # eager: a first call
    assert (stats["captures"], stats["replays"]) == (1, 2)
    assert ex.graph_stats["prefill"]["shapes"] == 2
    before = ex.graph_stats
    loose = eager.make_pool(PAGES + 2, PAGE)  # not held: run eagerly, no graph
    got, _ = ex.prefill_paged(tokens, loose, ROW, length=LENGTHS[0])
    assert torch.equal(got, want) and ex.graph_stats == before


# --- StepGraph's bookkeeping, through the stand-in runtime ---------------------------------------

@pytest.mark.parametrize("executor", ["galaxy", "zoo"])
def test_one_capture_serves_two_lengths(executor):
    """The prompt at lengths 13 (eager: the warm-up), 9 (captured, then
    replayed) and 13 (replayed): one capture, and each call's logits and
    pages are the eager step's on a twin pool."""
    ex = _galaxy() if executor == "galaxy" else _zoo()
    vocab = ex.embed.shape[0] if executor == "galaxy" else ex.cfg.vocab_size
    eager = copy.copy(ex)
    rt = StandInRuntime()
    ex._graph = graphs.StepGraph("cpu", runtime=rt)
    tokens = _tokens(vocab)
    for i, n in enumerate(LENGTHS + LENGTHS[:1]):
        pool, twin = ex.make_pool(PAGES, PAGE), eager.make_pool(PAGES, PAGE)
        got, _ = ex.prefill_paged(tokens, pool, ROW, length=n)
        want, _ = eager.prefill_paged(tokens, twin, ROW, length=n)
        assert torch.equal(got, want) and _equal(pool, twin), n
        stats = ex.graph_stats["prefill"]
        assert (stats["captures"], stats["replays"]) == (int(i > 0), i)
    assert len(rt.graphs) == 1 and rt.graphs[0].replays == 2
    assert ex.graph_stats["decode"]["shapes"] == ex.graph_stats["chunk"]["shapes"] == 0


def test_held_pool_graphs_outlive_pools_that_are_not_held():
    """A pool that is not held is refused, and the held pool's graphs
    stay; a draft's pool at the same geometry is another pool with graphs
    of its own; the target's held pool's graphs go with it when the target
    asks for another geometry, and the draft's stay.  ``stats_since``
    keeps the counts between two snapshots and the levels of the later
    one."""
    def step(pool, tokens, block_row, row):
        pool["k"] += 1
        return (tokens[:, row] + block_row.sum()).float()

    sg = graphs.StepGraph("cpu", runtime=StandInRuntime())
    make = lambda: {"k": torch.zeros(3)}  # noqa: E731
    zero = lambda p: p["k"].zero_()  # noqa: E731
    stats = sg.stats["prefill"]
    tok, row = np.arange(16)[None], np.array([1, 2])

    def call(pool, n=5):
        return sg.run(step, pool, tok, row, np.array([n - 1]), kind="prefill")

    held = sg.paged_pool(3, 8, make, zero)
    assert [call(held, n).tolist() for n in (5, 9)] == [[[7.0]], [[11.0]]]
    assert (stats["captures"], stats["replays"]) == (1, 1)
    loose = make()
    with pytest.raises(ValueError, match="holds"):
        call(loose)
    assert not sg.binds(loose) and sg.binds(held)
    before = copy.deepcopy(sg.stats)
    draft = sg.paged_pool(3, 8, make, zero, user="draft")
    assert draft is not held and sg.paged_pool(3, 8, make, zero) is held
    call(draft), call(draft)
    assert call(held, 3).tolist() == [[5.0]]  # the target's graph stayed
    run = graphs.stats_since(before, sg.stats)
    assert (run["prefill"]["shapes"], run["prefill"]["captures"],
            run["prefill"]["replays"]) == (1, 1, 2)
    assert run["prefill"]["pool_bytes"] == 4096 and run["paged_pool"]["pools"] == 2
    assert graphs.stats_since(None, sg.stats) is sg.stats
    assert sg.paged_pool(3, 8, make, zero) is held and held["k"].tolist() == [0.0] * 3
    bigger = sg.paged_pool(4, 8, make, zero)
    assert bigger is not held and not sg.binds(held)
    call(bigger)
    assert stats["captures"] == 2  # eager: a first call on the new pool
    call(draft)
    assert stats["captures"] == 2 and stats["replays"] == 4  # the draft's graph stayed
    assert sg.stats["paged_pool"] == {"pools": 2, "bytes": 24}


def test_self_draft_keeps_a_pool_apart_from_the_target():
    """A reduced qwen1.5-0.5b serve through the prefix cache that drafts
    with its own executor, k 2, twice with graphs: the target and the
    draft hold a pool each (the prefix hits share pages in the target's
    pool only, so one shared pool would let the draft's writes land on
    the target's pages), and each run's tokens and stats are those of
    graphs off."""
    ex = _zoo()
    vocab = ex.cfg.vocab_size
    rng = np.random.default_rng(11)
    shared = rng.integers(1, vocab, 16).tolist()
    prompts = [shared + rng.integers(1, vocab, n).tolist() for n in (5, 9, 3, 7)]

    def serve():
        eng = ServingEngine(ex, max_batch=2, max_len=40, page_size=PAGE, prefix_cache=True,
                            draft_executor=ex, spec_k=2)
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=p, max_new_tokens=4))
        return {r.uid: r.output for r in eng.run()}, dict(eng.stats)

    want, want_stats = serve()
    assert want_stats["prefix_hits"] > 0 and want_stats["spec_steps"] > 0
    ex._graph = graphs.StepGraph("cpu", runtime=StandInRuntime())
    for rnd in range(2):
        got, stats = serve()
        assert got == want and stats == want_stats, rnd
    assert ex.graph_stats["paged_pool"]["pools"] == 2
    assert ex.graph_stats["decode"]["replays"] > 0


def test_paged_graphs_survive_engine_runs():
    """A reduced qwen1.5-0.5b serve through the prefix cache (one-shot
    prefills, prefix-hit suffix chunks, decode steps) three times on one
    executor with graphs: each run's tokens and stats those of graphs off
    (a new run starts with no prefix hit), one held pool throughout, and
    the third run captures nothing."""
    ex = _zoo()
    vocab = ex.cfg.vocab_size
    rng = np.random.default_rng(7)
    shared = rng.integers(1, vocab, 16).tolist()
    prompts = [shared + rng.integers(1, vocab, n).tolist() for n in (4, 9, 4, 9)]
    prompts += [rng.integers(1, vocab, n).tolist() for n in (20, 22)]

    def serve():
        eng = ServingEngine(ex, max_batch=2, max_len=40, page_size=PAGE, prefix_cache=True)
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=p, max_new_tokens=3))
        return {r.uid: r.output for r in eng.run()}, dict(eng.stats)

    want, want_stats = serve()
    assert want_stats["prefill_oneshots"] >= 3 and want_stats["prefill_chunks"] >= 1
    ex._graph = graphs.StepGraph("cpu", runtime=StandInRuntime())
    runs = []
    for rnd in range(3):
        before = ex.graph_stats
        got, stats = serve()
        assert got == want and stats == want_stats, rnd
        runs.append(graphs.stats_since(before, ex.graph_stats))
    assert runs[0]["decode"]["captures"] == 1 and runs[0]["prefill"]["captures"] >= 1
    assert runs[1]["decode"]["captures"] == 0
    assert all(runs[2][k]["captures"] == 0 for k in ("decode", "prefill", "chunk")), runs[2]
    assert runs[2]["prefill"]["replays"] == want_stats["prefill_oneshots"]
    assert runs[2]["decode"]["replays"] == want_stats["decode_steps"]
    assert ex.graph_stats["paged_pool"]["pools"] == 1


def test_serve_on_a_taken_executor_keeps_graphs_and_draft_tokens(monkeypatch):
    """Reduced GPT2-L on the 4-device plan with a DistilBERT-shaped draft,
    k 2: three ``launch.serve.serve(executor=..., draft_executor=...)``
    calls with graphs (the stand-in runtime in place of the card's) give
    the tokens and stats of graphs off; the second keeps the first's
    graphs (no decode or prefill capture), the third captures nothing."""
    kw = dict(reduce=True, prompt_lens=[20, 25, 20, 25], max_new=4, max_batch=2, spec_k=2)
    want = launch_serve.serve("gpt2-l", device="cpu", draft_model="distilbert", **kw)
    ex, draft = want["executor"], want["draft_executor"]
    # the card's runtime and device check, stood in for on the CPU
    monkeypatch.setattr(graphs, "CudaRuntime", StandInRuntime)
    monkeypatch.setattr(launch_serve, "resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    runs = []
    for rnd in range(3):
        got = launch_serve.serve("gpt2-l", executor=ex, draft_executor=draft, graphs=True,
                                 **kw)
        assert ex.graphs and draft.graphs
        assert ({r.uid: r.output for r in got["requests"]}
                == {r.uid: r.output for r in want["requests"]}), rnd
        assert got["stats"] == want["stats"], rnd
        runs.append(got["graph_stats"])
    first, second, third = runs
    assert first["target"]["prefill"]["captures"] == 1  # 4 prompts padded to one shape
    assert first["draft"]["prefill"]["captures"] == first["draft"]["decode"]["captures"] == 1
    for side in ("target", "draft"):
        assert second[side]["prefill"]["captures"] == second[side]["decode"]["captures"] == 0
        assert second[side]["prefill"]["replays"] == want["stats"]["prefill_oneshots"]
        assert all(third[side][k]["captures"] == 0 for k in graphs.KINDS), third
    assert third["target"]["chunk"]["replays"] == want["stats"]["spec_steps"]
    assert second["target"]["paged_pool"]["pools"] == 1
