"""The wave protocol's steps (``prefill`` / ``decode`` of both executors),
their held wave caches and their captured graphs (``serving/graphs.py``),
on the CPU.

What the CPU can hold of a captured wave step:

* the wave prefill step (tokens and each row's logits row on the device)
  and the wave decode step (each row's write position on the device) read
  no tensor value on the host, size no output by their data and build no
  tensor from host data once a shape has been warmed up (a
  ``TorchDispatchMode``): the uneven 4-device Galaxy plan on ``LocalRing``
  (both backends), reduced RecurrentGemma-9B and reduced xlstm-350m;
* the same steps against the reference: RecurrentGemma's against the
  reference executor's ``prefill`` / ``decode`` (JAX, CPU, jitted once a
  shape), the
  Galaxy's on a one-device plan against the reference executor's on a
  one-device mesh, and on the uneven 4-device plan against the
  reference's full-context ``reference_stack`` logits;
* the lockstep index broadcast to ``(B,)`` gives the host-int path's
  logits and cache bitwise (a sliding window of 8 wrapped by the decode
  steps: the ring-buffer slot ``torch.remainder``), and the prefill's
  device rows the host-int row's;
* ``reset_cache`` / ``hmp.reset_kv_cache`` give a fresh cache bitwise after
  a dirty wave, and with graphs on ``make_cache`` hands the same storage
  to every wave of a batch size;
* ``StepGraph``'s bookkeeping for the wave kinds through a stand-in
  runtime: ``wave_decode`` captured on a shape's first call,
  ``wave_prefill`` on its second; graphs on two held caches survive
  alternating waves and a new paged pool drops only the pool's graphs; a
  stand-in replay serves two decode indices from one capture; a wave
  serve through the stand-in gives the tokens of graphs off and a second
  serve captures nothing new.

Tolerance: fp32, 1e-4 on logits (PyTorch's and XLA's CPU matmuls sum in
different orders).  The bitwise comparisons of graphs on and off on the
card are ``cuda``-marked in ``tests/test_torch_cuda.py``.
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
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving import graphs  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine, TransformerExecutor  # noqa: E402
from repro_torch.serving.galaxy import GalaxyHMPExecutor  # noqa: E402
from repro_torch.serving.kvcache import make_cache, reset_cache  # noqa: E402
from torch_helpers import NoHostReads, StandInRuntime, numpy_params  # noqa: E402

TOL = dict(atol=1e-4, rtol=0)
LENGTHS = np.array([12, 9])  # a wave of two prompts right-padded to 12
STEPS = 2  # decode steps after the prefill


def _guarded(ex, tokens, steps=STEPS, max_len=16):
    """A warm-up wave on a scratch cache, then a wave of ``tokens`` (B, S)
    with ``LENGTHS``: the prefill step and ``steps`` teacher-forced decode
    steps at per-row positions, each under the dispatch mode on device
    tensors.  Yields (kind, index or None, logits, cache)."""
    b, s = tokens.shape[0], LENGTHS.max()
    prompt = torch.as_tensor(tokens[:, :s])
    rows = torch.as_tensor(LENGTHS - 1)
    ex._wave_prefill_step(ex.make_cache(b, max_len), prompt, rows)
    cache = ex.make_cache(b, max_len)
    with NoHostReads(host_data=True):
        logits = ex._wave_prefill_step(cache, prompt, rows)
    yield "prefill", None, logits, cache
    for step in range(steps):
        index = LENGTHS + step
        tok = torch.as_tensor(tokens[np.arange(b), index][:, None])
        index_t = torch.as_tensor(index)
        with NoHostReads(host_data=True):
            logits = _decode_step(ex)(cache, tok, index_t)
        yield "decode", index, logits, cache


def _decode_step(ex):
    return ex._decode_step if isinstance(ex, GalaxyHMPExecutor) else ex._wave_decode_step


# --- the zoo's steps -----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _zoo(arch):
    jcfg, cfg = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    tree = numpy_params(jcfg)
    return (TransformerExecutor(params_from_numpy(tree), cfg),
            JExecutor(jax.tree.map(jnp.asarray, tree), jcfg))


def test_zoo_wave_steps_read_nothing_and_match_reference():
    """RecurrentGemma: the windowed attention, the RG-LRU prefill from the
    cache's state and its one-token step."""
    ex, jex = _zoo("recurrentgemma-9b")
    tokens = np.random.default_rng(4).integers(1, ex.cfg.vocab_size, (2, 16))
    jcache = jex.make_cache(2, 16)
    for kind, index, logits, _ in _guarded(ex, tokens):
        if kind == "prefill":
            want, jcache = jex.prefill(jnp.asarray(tokens[:, :12], jnp.int32), jcache,
                                       lengths=jnp.asarray(LENGTHS, jnp.int32))
        else:
            tok = tokens[np.arange(2), index][:, None]
            want, jcache = jex.decode(jnp.asarray(tok, jnp.int32), jcache,
                                      jnp.asarray(index, jnp.int32))
        np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)


def test_xlstm_wave_steps_read_nothing_on_the_host():
    """xLSTM's mLSTM and sLSTM prefill and steps (the reference's own
    served tokens are held in ``tests/test_torch_xlstm.py``)."""
    ex, _ = _zoo("xlstm-350m")
    tokens = np.random.default_rng(4).integers(1, ex.cfg.vocab_size, (2, 16))
    for _, _, logits, _ in _guarded(ex, tokens):
        assert logits.shape == (2, ex.cfg.vocab_size) and torch.isfinite(logits).all()


def test_zoo_per_row_paths_are_bitwise_the_host_int_paths():
    """A uniform wave of RecurrentGemma with an 8-slot window, decoded past
    it: the wrappers' per-row rows and write positions against
    ``apply_model`` with host ints, logits and every cache leaf."""
    ex, _ = _zoo("recurrentgemma-9b")
    ex = TransformerExecutor(ex.params, dataclasses.replace(ex.cfg, window=8))
    tokens = np.random.default_rng(6).integers(1, ex.cfg.vocab_size, (3, 12))
    cache, host = ex.make_cache(3, 16), ex.make_cache(3, 16)
    got, _ = ex.prefill(tokens[:, :10], cache)
    want, _ = ex._model(tokens=torch.as_tensor(tokens[:, :10]), mode="prefill", cache=host,
                        rows=9)
    assert torch.equal(got, want)
    for index in (10, 11):
        tok = tokens[:, index:index + 1]
        got, _ = ex.decode(tok, cache, index)
        want, _ = ex._model(tokens=torch.as_tensor(tok), mode="decode", cache=host,
                            cache_index=index)
        assert torch.equal(got, want[:, -1])
        assert all(torch.equal(a, b) for a, b in zip(graphs.leaves(cache),
                                                       graphs.leaves(host)))


# --- the Galaxy steps ------------------------------------------------------------------

SHARES = dict(heads=(6, 4, 4, 2), columns=(24, 16, 16, 8), head_dim=2, d_model=32,
              seq_shares=(3.0, 2.0, 2.0, 1.0))
ONE = dict(heads=(16,), columns=(64,), head_dim=2, d_model=32)


@functools.lru_cache(maxsize=None)
def _galaxy_stack():
    """2 reference-layout layers drawn with numpy at d 32 (16 heads of 2,
    d_ff 64), vocab 50; a wave's tokens and their full-context reference
    logits (causal: row p is what a step at position p gives)."""
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
    tokens = rng.integers(1, 50, (2, 16))
    ref = np.asarray(jax.jit(jhmp.reference_stack)(layers, jnp.asarray(emb)[tokens]) @ emb.T)
    return layers, emb, tokens, ref


def _galaxy(shares, ring, backend="kernel"):
    layers, emb, _, _ = _galaxy_stack()
    lt, et = hmp.params_from_numpy(layers, emb)
    return GalaxyHMPExecutor(lt, et, ExecPlan(**shares).with_backend(backend), ring)


@pytest.mark.parametrize("backend", ["kernel", "eager"])
def test_galaxy_wave_steps_read_nothing_and_match_full_context(backend):
    """The uneven 4-device plan on ``LocalRing``: each row's logits are the
    full-context reference's at its position."""
    _, _, tokens, ref = _galaxy_stack()
    ex = _galaxy(SHARES, LocalRing(4), backend)
    for kind, index, logits, _ in _guarded(ex, tokens):
        pos = LENGTHS - 1 if index is None else index
        np.testing.assert_allclose(logits.numpy(), ref[np.arange(2), pos], **TOL)


def test_galaxy_wave_steps_match_reference_executor():
    """A one-device plan against the reference executor's ``prefill`` and
    ``decode`` on a one-device mesh, call for call."""
    layers, emb, tokens, _ = _galaxy_stack()
    ex = _galaxy(ONE, LocalRing(1))
    jex = JGalaxy(jax.tree.map(jnp.asarray, layers), jnp.asarray(emb), JExecPlan(**ONE),
                  make_mesh_compat((1,), ("model",)))
    jcache = jex.make_cache(2, 16)
    for kind, index, logits, _ in _guarded(ex, tokens):
        if kind == "prefill":
            want, jcache = jex.prefill(jnp.asarray(tokens[:, :12], jnp.int32), jcache,
                                       lengths=jnp.asarray(LENGTHS, jnp.int32))
        else:
            tok = tokens[np.arange(2), index][:, None]
            want, jcache = jex.decode(jnp.asarray(tok, jnp.int32), jcache,
                                      jnp.asarray(index, jnp.int32))
        np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)


# --- held wave caches -------------------------------------------------------------------

@pytest.mark.parametrize("executor", ["galaxy", "zoo"])
def test_held_cache_resets_to_a_fresh_cache_in_place(executor):
    """After a dirty wave (xLSTM's stabilizers and normalizers start off
    zero) the held cache is bitwise a fresh one, at the same storage; the
    executor without graphs makes a new cache each time."""
    if executor == "galaxy":
        ex = _galaxy(SHARES, LocalRing(4))
        fresh = lambda: hmp.make_kv_cache(2, 16, 2, ex.plan, devices=ex.ring.devices)  # noqa: E731
    else:
        ex, _ = _zoo("xlstm-350m")
        ex = copy.copy(ex)
        fresh = lambda: make_cache(ex.cfg, 2, 16)  # noqa: E731
    assert ex.make_cache(2, 16) is not ex.make_cache(2, 16)
    ex._graph = graphs.StepGraph("cpu", runtime=StandInRuntime())
    cache = ex.make_cache(2, 16)
    where = graphs.storage(cache)
    for t in graphs.leaves(cache):
        t.fill_(float("nan"))
    again = ex.make_cache(2, 16)
    assert again is cache and graphs.storage(again) == where
    assert all(torch.equal(a, b) for a, b in zip(graphs.leaves(again), graphs.leaves(fresh())))
    assert ex.graph_stats["wave_caches"] == {
        "caches": 1, "bytes": sum(t.numel() * 4 for t in graphs.leaves(cache))}
    assert ex.make_cache(1, 16) is not cache and ex.make_cache(2, 16) is cache
    assert ex.make_cache(2, 24) is not cache  # another max_len: a new cache
    assert ex.graph_stats["wave_caches"]["caches"] == 2
    if executor == "zoo":
        tree = fresh()
        for t in graphs.leaves(tree):
            t.normal_()
        reset_cache(tree)
        assert all(torch.equal(a, b) for a, b in zip(graphs.leaves(tree),
                                                       graphs.leaves(fresh())))


# --- StepGraph's bookkeeping for waves, through a stand-in runtime -----------------------

def test_wave_graphs_capture_per_kind_and_survive_alternating_waves():
    calls = []

    def step(cache, tokens, extra):
        calls.append(tokens.shape)
        ops.KERNELS["tiled_gemm_valid"].launches += 1
        cache["k"] += 1
        return (tokens + extra[:, None]).float()

    ops.reset_launch_counts()
    rt = StandInRuntime()
    sg = graphs.StepGraph("cpu", runtime=rt)
    make = {b: (lambda b=b: {"k": torch.zeros(b)}) for b in (4, 2)}
    zero = lambda c: c["k"].zero_()  # noqa: E731
    dec, pre = sg.stats["wave_decode"], sg.stats["wave_prefill"]
    for wave in range(3):
        for b in (4, 2):  # waves of 4 rows and of 2, alternating
            cache = sg.wave_cache(b, 16, make[b], zero)
            out = sg.run(step, cache, np.ones((b, 5), np.int64), np.arange(b),
                         kind="wave_prefill")
            assert out[:, 0].tolist() == [1.0 + i for i in range(b)]
            for i in range(3):
                sg.run(step, cache, np.full((b, 1), i), np.full(b, 7 + i), kind="wave_decode")
            assert cache["k"].tolist() == [4.0] * b  # reset, then the prefill and 3 steps
    assert (dec["captures"], dec["replays"], dec["shapes"]) == (2, 16, 2)
    assert (pre["captures"], pre["replays"], pre["shapes"]) == (2, 4, 2)
    assert ops.launch_counts()["tiled_gemm_valid"] == 6 * 4
    pool = sg.paged_pool(3, 8, lambda: {"k": torch.zeros(3)}, zero)
    sg.run(step, pool, np.zeros((3, 1), np.int64), np.zeros(3, np.int64))
    pool = sg.paged_pool(5, 8, lambda: {"k": torch.zeros(3)}, zero)
    sg.run(step, pool, np.zeros((3, 1), np.int64), np.zeros(3, np.int64))
    assert sg.stats["decode"]["captures"] == 2  # another geometry: the pool's graphs went
    cache = sg.wave_cache(4, 16, make[4], zero)
    sg.run(step, cache, np.ones((4, 1), np.int64), np.arange(4), kind="wave_decode")
    assert dec["captures"] == 2 and dec["replays"] == 17  # the wave graphs stayed
    with pytest.raises(ValueError, match="wave cache"):
        sg.run(step, {"k": torch.zeros(4)}, np.ones((4, 1), np.int64), np.arange(4),
               kind="wave_decode")
    cache = sg.wave_cache(4, 24, make[4], zero)  # another max_len: its graphs went
    sg.run(step, cache, np.ones((4, 1), np.int64), np.arange(4), kind="wave_decode")
    cache = sg.wave_cache(2, 16, make[2], zero)  # batch 2's stayed
    sg.run(step, cache, np.ones((2, 1), np.int64), np.arange(2), kind="wave_decode")
    assert dec["captures"] == 3 and dec["replays"] == 18
    ops.reset_launch_counts()


@pytest.mark.parametrize("executor", ["galaxy", "zoo"])
def test_one_capture_serves_every_decode_index(executor):
    """A wave's prefill twice (eager, then captured) and decode steps at
    indices 12, 13 (captured at 12) and 9: each replay's logits and cache
    the eager step's on a twin cache."""
    if executor == "galaxy":
        ex, vocab = _galaxy(SHARES, LocalRing(4)), 50
    else:
        ex, _ = _zoo("recurrentgemma-9b")
        ex, vocab = copy.copy(ex), ex.cfg.vocab_size
    eager = copy.copy(ex)
    rt = StandInRuntime()
    ex._graph = graphs.StepGraph("cpu", runtime=rt)
    tokens = np.random.default_rng(8).integers(1, vocab, (2, 12))
    for i in range(2):
        cache, twin = ex.make_cache(2, 16), eager.make_cache(2, 16)
        got, _ = ex.prefill(tokens, cache, lengths=LENGTHS)
        want, _ = eager.prefill(tokens, twin, lengths=LENGTHS)
        assert torch.equal(got, want) and _equal(cache, twin), i
    assert ex.graph_stats["wave_prefill"]["captures"] == 1
    for index in (12, 13, 9):
        tok = tokens[:, index % 12:index % 12 + 1]
        got, _ = ex.decode(tok, cache, index)
        want, _ = eager.decode(tok, twin, index)
        assert torch.equal(got, want) and _equal(cache, twin), index
    assert (ex.graph_stats["wave_decode"]["captures"],
            ex.graph_stats["wave_decode"]["replays"]) == (1, 2)
    assert [g.replays for g in rt.graphs] == [1, 2]


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(graphs.leaves(a), graphs.leaves(b)))


def test_wave_serve_through_the_stand_in_gives_the_eager_tokens():
    """Five requests on the 4-device Galaxy plan in waves of 3 and 2 rows
    (max_batch 3), twice: the tokens of graphs off each time, one decode
    capture per wave batch size, the second serve capturing nothing."""
    ex = _galaxy(SHARES, LocalRing(4))
    prompts = [[1, 2, 3, 4, 5, 6, 7, 8], [4, 7, 1, 9, 2, 8, 3, 6], [3, 1, 4, 1, 5, 9, 2, 6],
               [2, 7, 1, 8, 2, 8], [5, 5, 3, 8, 1, 2]]

    def serve():
        eng = ServingEngine(ex, max_batch=3, max_len=16, scheduler="wave")
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=p, max_new_tokens=4))
        return {r.uid: r.output for r in eng.run()}, eng.stats["decode_steps"]

    want, _ = serve()
    ex._graph = graphs.StepGraph("cpu", runtime=StandInRuntime())
    for rnd in range(2):
        got, steps = serve()
        assert got == want, rnd
        dec = ex.graph_stats["wave_decode"]
        assert (dec["captures"], dec["replays"]) == (2, (rnd + 1) * steps - 2)
    assert ex.graph_stats["wave_caches"]["caches"] == 2
