"""The chunk step at a device-held offset (``prefill_chunk`` of both
executors) and its captured graphs (``serving/graphs.py``), on the CPU.

What the CPU can hold of a captured chunk:

* the chunk step of both executors (``_chunk_step``: tokens, block row and
  offset on the device) reads no tensor value on the host, sizes no output
  by its data and builds no tensor from host data once a shape has been
  warmed up (a ``TorchDispatchMode``; the warm-up call is a graph's first,
  eager one): the uneven 4-device Galaxy plan on ``LocalRing`` (both
  backends), reduced qwen1.5-0.5b and StableLM-12B, olmoe-1b-7b and
  granite-moe-3b-a800m;
* the same steps against the reference at offset 0, a mid-page offset, a
  prefix-hit offset (another request's pages below it) and a 5-row (k + 1)
  verify chunk: the zoo's against the reference's ``prefill_chunk`` (JAX,
  CPU, jitted once a shape), the Galaxy's on a one-device plan against the
  reference executor's ``prefill_chunk`` on a one-device mesh, and on the
  uneven 4-device plan (which this process's one CPU device cannot hold
  for the reference) against the reference's full-context
  ``reference_stack`` logits;
* the offset is really an input: a stand-in runtime whose replay re-runs
  the captured closure on the graph's buffers serves two offsets from one
  capture, each with the eager step's logits and pages;
* ``StepGraph``'s bookkeeping for chunks: a shape's first call eager, its
  second captured and replayed, several shapes live at once, all dropped
  with the held pool for a pool of another geometry, a pool not held
  refused, launch counts per shape;
* ``flash_attention_plain`` with ``kv_len`` equals the call on the keys
  sliced to ``kv_len``;
* ``trace_serve --cuda-graphs`` refused with ``--device cpu``.

Tolerance: fp32, 1e-4 on logits (PyTorch's and XLA's CPU matmuls sum in
different orders, and the whole row's context adds masked keys to each
softmax); 1e-6 for the plain attention with ``kv_len`` against the sliced
keys (the same masked terms, summed over more exact zeros).  The bitwise
comparisons on the card are ``cuda``-marked in ``tests/test_torch_cuda.py``.
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
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.launch import trace_serve  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.serving import graphs  # noqa: E402
from repro_torch.serving.engine import TransformerExecutor  # noqa: E402
from repro_torch.serving.galaxy import GalaxyHMPExecutor  # noqa: E402
from torch_helpers import (  # noqa: E402
    CountingRuntime, NoHostReads, StandInRuntime, numpy_params)

TOL = dict(atol=1e-4, rtol=0)
PAGE = 8
#: request A: pages 1-4; request B shares A's first two pages (a prefix hit
#: of 16 tokens) and owns 5 and 6
ROW_A, ROW_B = np.array([1, 2, 3, 4]), np.array([1, 2, 5, 6])
#: (request, offset, rows): offset 0, a page-aligned 5-row chunk, a
#: mid-page offset, and B's 5-row (k + 1 at k 4) chunk behind the prefix hit
CALLS = (("A", 0, 8), ("A", 8, 5), ("A", 13, 8), ("B", 16, 5))
PREFIX = 16


def _tokens(vocab):
    """Request A's 21 tokens and B's: A's first 16, then 5 of its own."""
    rng = np.random.default_rng(5)
    a = rng.integers(1, vocab, (1, 21))
    b = np.concatenate([a[:, :PREFIX], rng.integers(1, vocab, (1, 5))], axis=1)
    return {"A": a, "B": b}


def _warm(ex, num_pages):
    """A shape's first call (a graph's eager warm-up) on a scratch pool:
    what a step keeps from host data (a layout's row map and mask) is
    built here, never again."""
    scratch = ex.make_pool(num_pages, PAGE)
    for s in sorted({s for _, _, s in CALLS}):
        ex.prefill_chunk(np.zeros((1, s), np.int64), scratch, ROW_A, offset=0, length=s)


def _guarded_chunks(ex, toks, num_pages):
    """The four calls of ``CALLS``, each through the executor's
    ``_chunk_step`` on device tensors under the dispatch mode; yields
    (request, offset, rows, logits)."""
    _warm(ex, num_pages)
    pool = ex.make_pool(num_pages, PAGE)
    rows = {"A": ROW_A, "B": ROW_B}
    for req, off, s in CALLS:
        args = (torch.as_tensor(toks[req][:, off:off + s]), torch.as_tensor(rows[req]),
                torch.as_tensor(off))
        with NoHostReads(host_data=True):
            logits = ex._chunk_step(pool, *args)
        yield req, off, s, logits


def test_guard_catches_tensors_built_from_host_data():
    t = torch.arange(4)
    for build in (lambda: torch.as_tensor(np.arange(3)), lambda: torch.tensor([1, 2]),
                  lambda: torch.tensor(3), lambda: torch.from_numpy(np.arange(3)),
                  lambda: t[np.array([0, 1])], lambda: t[[0, 1]]):
        with pytest.raises(AssertionError, match="host data"), NoHostReads(host_data=True):
            build()
    with NoHostReads(host_data=True):  # device-side work is fine
        t[torch.arange(2)] + 1, torch.as_tensor(t), torch.full((), 3)


# --- the Galaxy chunk step ---------------------------------------------------------------

SHARES = dict(heads=(6, 4, 4, 2), columns=(24, 16, 16, 8), head_dim=2, d_model=32,
              seq_shares=(3.0, 2.0, 2.0, 1.0))
ONE = dict(heads=(16,), columns=(64,), head_dim=2, d_model=32)


@functools.lru_cache(maxsize=None)
def _galaxy_stack():
    """2 layers at d 32 (16 heads of 2, d_ff 64), vocab 50; both requests'
    tokens and their full-context reference logits."""
    layers = jhmp.init_stack_params(jax.random.PRNGKey(0), 2, 32, 16, 64)
    emb = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (50, 32))) * 0.5
    toks = _tokens(50)
    stack = jax.jit(jhmp.reference_stack)
    ref = {k: np.asarray(stack(layers, jnp.asarray(emb)[t]) @ emb.T) for k, t in toks.items()}
    return layers, emb, toks, ref


@pytest.mark.parametrize("backend", ["kernel", "eager"])
def test_galaxy_chunk_step_reads_nothing_and_matches_full_context(backend):
    """The uneven 4-device plan on ``LocalRing``: each chunk row's logits
    are the full-context reference's at its position."""
    layers, emb, toks, ref = _galaxy_stack()
    lt, et = hmp.params_from_numpy(layers, emb)
    ex = GalaxyHMPExecutor(lt, et, ExecPlan(**SHARES).with_backend(backend), LocalRing(4))
    for req, off, s, logits in _guarded_chunks(ex, toks, 7):
        np.testing.assert_allclose(logits.numpy()[0], ref[req][0, off:off + s], **TOL)


def test_galaxy_chunk_step_matches_reference_prefill_chunk():
    """A one-device plan against the reference executor's ``prefill_chunk``
    on a one-device mesh, call for call on pools that move together."""
    layers, emb, toks, _ = _galaxy_stack()
    lt, et = hmp.params_from_numpy(layers, emb)
    ex = GalaxyHMPExecutor(lt, et, ExecPlan(**ONE), LocalRing(1))
    jex = JGalaxy(layers, jnp.asarray(emb), JExecPlan(**ONE),
                  make_mesh_compat((1,), ("model",)))
    jpool = jex.make_pool(7, PAGE)
    rows = {"A": ROW_A, "B": ROW_B}
    for req, off, s, logits in _guarded_chunks(ex, toks, 7):
        want, jpool = jex.prefill_chunk(jnp.asarray(toks[req][:, off:off + s], jnp.int32),
                                        jpool, jnp.asarray(rows[req], jnp.int32),
                                        offset=off, length=off + s)
        np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)


# --- the zoo's chunk step --------------------------------------------------------------

def _zoo_pair(arch):
    jcfg, cfg = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    if arch == "stablelm-12b":  # keep GQA under test
        jcfg = dataclasses.replace(jcfg, num_kv_heads=2)
        cfg = dataclasses.replace(cfg, num_kv_heads=2)
    tree = numpy_params(jcfg)
    return (TransformerExecutor(params_from_numpy(tree), cfg),
            JExecutor(jax.tree.map(jnp.asarray, tree), jcfg))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "stablelm-12b"])
def test_zoo_chunk_step_reads_nothing_and_matches_reference(arch):
    ex, jex = _zoo_pair(arch)
    toks = _tokens(ex.cfg.vocab_size)
    jpool = jex.make_pool(7, PAGE)
    rows = {"A": ROW_A, "B": ROW_B}
    for req, off, s, logits in _guarded_chunks(ex, toks, 7):
        want, jpool = jex.prefill_chunk(jnp.asarray(toks[req][:, off:off + s], jnp.int32),
                                        jpool, jnp.asarray(rows[req], jnp.int32),
                                        offset=off, length=off + s)
        np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "granite-moe-3b-a800m"])
def test_moe_chunk_step_reads_nothing_on_the_host(arch):
    """The MoE archs' routing, capacity and combine in a chunk stay on the
    device, and the step gives the host-int path's logits."""
    cfg = reduced(get_config(arch))
    ex = TransformerExecutor(init_params(cfg, generator=torch.Generator().manual_seed(0)),
                             cfg)
    got = {(req, off): logits for req, off, _, logits in
           _guarded_chunks(ex, _tokens(cfg.vocab_size), 7)}
    # the same calls through the host-int path: keys sliced at offset + S
    toks, rows = _tokens(cfg.vocab_size), {"A": ROW_A, "B": ROW_B}
    pool = ex.make_pool(7, PAGE)
    for req, off, s in CALLS:
        dense = ex.gather_pages(pool, torch.as_tensor(rows[req])[None])
        want, dense = ex._model(tokens=torch.as_tensor(toks[req][:, off:off + s]),
                                mode="prefill", cache=dense, cache_index=off)
        pos = off + torch.arange(s)
        row = torch.as_tensor(rows[req])
        ex._scatter(pool, dense, row[pos // PAGE], pos % PAGE, torch.zeros_like(pos), pos)
        np.testing.assert_allclose(got[req, off].numpy(), want.numpy(), **TOL)


# --- one capture, two offsets -----------------------------------------------------------

def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_clone(v) for v in tree]
    return tree.clone()


def _leaves_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(graphs.leaves(a), graphs.leaves(b)))


@pytest.mark.parametrize("executor", ["galaxy", "zoo"])
def test_one_capture_serves_every_offset(executor):
    """A 5-row chunk at offsets 0 (eager: the warm-up), 8 (captured, then
    replayed), 13 and 3 (replayed): one capture, and each call's logits and
    pages are the eager step's on a twin pool."""
    if executor == "galaxy":
        layers, emb, _, _ = _galaxy_stack()
        lt, et = hmp.params_from_numpy(layers, emb)
        ex = GalaxyHMPExecutor(lt, et, ExecPlan(**SHARES), LocalRing(4))
        vocab = 50
    else:
        ex, _ = _zoo_pair("qwen1.5-0.5b")
        vocab = ex.cfg.vocab_size
    eager = copy.copy(ex)
    rt = StandInRuntime()
    ex._graph = graphs.StepGraph("cpu", runtime=rt)
    pool = ex.make_pool(7, PAGE)
    gen = torch.Generator().manual_seed(9)
    for leaf in graphs.leaves(pool):
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    twin = _clone(pool)
    tok = np.random.default_rng(9).integers(0, vocab, (1, 5))
    for i, off in enumerate((0, 8, 13, 3)):
        got, _ = ex.prefill_chunk(tok, pool, ROW_A, offset=off, length=off + 5)
        want, _ = eager.prefill_chunk(tok, twin, ROW_A, offset=off, length=off + 5)
        assert torch.equal(got, want) and _leaves_equal(pool, twin), off
        assert ex.graph_stats["chunk"]["captures"] == (i > 0)
        assert ex.graph_stats["chunk"]["replays"] == i
    assert len(rt.graphs) == 1 and rt.graphs[0].replays == 3
    assert ex.graph_stats["decode"]["captures"] == 0


# --- StepGraph's bookkeeping for chunks ----------------------------------------------------

def test_chunk_graphs_capture_on_the_second_call_per_shape():
    seen = []

    def step(pool, tokens, block_row, offset):
        """Launch counts by row count, and logits made of the inputs."""
        seen.append((tokens, block_row, offset))
        n = tokens.shape[1]
        ops.KERNELS["tiled_gemm_valid"].launches += n
        ops.KERNELS["tiled_gemm_valid"].paths["mma"] += n
        pool["k"] += 1
        return (tokens + offset + block_row.sum()).float()

    ops.reset_launch_counts()
    rt = CountingRuntime()
    sg = graphs.StepGraph("cpu", runtime=rt)
    make = lambda: {"k": torch.zeros(2)}  # noqa: E731
    zero = lambda p: p["k"].zero_()  # noqa: E731
    pool = sg.paged_pool(7, PAGE, make, zero)
    row = np.array([3, 4])
    stats = sg.stats["chunk"]
    five, two = np.arange(5)[None], np.arange(2)[None]
    assert sg.run(step, pool, five, row, 4, kind="chunk").tolist() == [[11., 12., 13., 14.,
                                                                        15.]]
    assert stats["captures"] == 0 and not rt.graphs  # the first call: eager
    sg.run(step, pool, two, row, 0, kind="chunk")
    assert ops.launch_counts()["tiled_gemm_valid"] == 7 and stats["captures"] == 0
    sg.run(step, pool, five, row, 9, kind="chunk")  # the second: capture, replay
    assert stats["captures"] == 1 and stats["replays"] == 1 and rt.graphs[0].replays == 1
    assert ops.launch_counts()["tiled_gemm_valid"] == 12  # the replay's 5, not the capture's
    five_bufs = seen[-1]
    assert five_bufs[2].shape == () and int(five_bufs[2]) == 9  # the offset is a buffer
    sg.run(step, pool, two, row, 6, kind="chunk")  # two shapes live at once
    sg.run(step, pool, five, row, 2, kind="chunk")
    sg.run(step, pool, two, row, 1, kind="chunk")
    assert stats["captures"] == 2 and stats["replays"] == 4
    assert [g.replays for g in rt.graphs] == [2, 2]
    assert int(five_bufs[2]) == 2 and five_bufs[0].tolist() == [[0, 1, 2, 3, 4]]
    assert ops.launch_counts()["tiled_gemm_valid"] == 12 + 2 + 5 + 2
    assert ops.path_counts()["tiled_gemm_valid"]["mma"] == 21
    assert sg.stats["decode"]["captures"] == 0

    with pytest.raises(ValueError, match="holds"):  # a pool it does not hold
        sg.run(step, make(), five, row, 0, kind="chunk")
    other = sg.paged_pool(9, PAGE, make, zero)  # another geometry drops every graph
    sg.run(step, other, five, row, 0, kind="chunk")
    assert stats["captures"] == 2 and len(rt.graphs) == 2  # eager again: a first call
    sg.run(step, other, five, row, 0, kind="chunk")
    assert stats["captures"] == 3 and [g.replays for g in rt.graphs] == [2, 2, 1]
    with pytest.raises(ValueError, match="step kind"):
        sg.run(step, other, five, row, 0, kind="verify")
    ops.reset_launch_counts()


# --- the plain attention with kv_len ---------------------------------------------------------

@pytest.mark.parametrize("causal, window", [(True, 0), (True, 6), (False, 0)])
def test_flash_plain_kv_len_equals_sliced_keys(causal, window):
    """Batch entry b with ``kv_len[b]`` keys of a longer view: the call on
    its keys sliced there (GQA 4 on 2)."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(3, 4, 5, 16, generator=g)
    k, v = (torch.randn(3, 2, 40, 16, generator=g) for _ in range(2))
    kv_len = torch.tensor([5, 17, 40], dtype=torch.int32)
    out = flash_attention_plain(q, k, v, causal=causal, window=window, kv_len=kv_len)
    for b, n in enumerate(kv_len.tolist()):
        want = flash_attention_plain(q[b:b + 1], k[b:b + 1, :, :n], v[b:b + 1, :, :n],
                                     causal=causal, window=window)
        np.testing.assert_allclose(out[b:b + 1].numpy(), want.numpy(), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention_plain(q, k, v, chunk=2, kv_len=kv_len)


def test_trace_serve_refuses_cuda_graphs_on_the_cpu(monkeypatch):
    monkeypatch.setattr(trace_serve, "trace", lambda *a, **k: pytest.fail("traced"))
    with pytest.raises(SystemExit, match="--device cpu"):
        trace_serve.main(["--model", "gpt2-l", "--reduce", "--device", "cpu",
                          "--cuda-graphs"])
