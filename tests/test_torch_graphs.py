"""The captured decode step (``serving/graphs.py``) on the CPU.

What the CPU can hold of a CUDA graph:

* the decode step of both executors reads no tensor value on the host and
  sizes no output by its data (a ``TorchDispatchMode`` raises on such an
  op), with slots at different depths and an idle slot on the null page:
  the uneven 4-device Galaxy plan on ``LocalRing`` (both backends), the
  dense zoo (reduced qwen1.5-0.5b and StableLM) and the MoE archs served
  paged (reduced olmoe-1b-7b and granite-moe-3b-a800m);
* the same eager steps against the reference: the zoo's against the
  reference's ``decode_paged`` (JAX, CPU, jitted once a shape), the
  Galaxy's against the reference's full-context ``reference_stack``
  logits (the reference's Galaxy ``decode_paged`` runs on a 4-device mesh,
  which this process's one CPU device cannot hold);
* ``graphs=True`` refused off the card, under the sharding rules and on a
  ``ProcessRing``; ``launch.serve --cuda-graphs`` refused with ``--ranks 2``
  and ``--device cpu`` before any serve;
* ``StepGraph``'s bookkeeping through a stand-in runtime: one capture a
  held pool, a pool of another geometry or a new shape captures again, a
  pool it does not hold is refused, inputs land in the buffers the graph
  reads, launch counts add the captured launches per replay;
* the capture guards: no workspace growth and no kernel build while a
  stream is capturing.

Tolerance: fp32, 1e-4 on logits (as the other parity tests: PyTorch's and
XLA's CPU matmuls sum in different orders).  The bitwise comparisons of
graphs on and off are ``cuda``-marked in ``tests/test_torch_cuda.py``.
"""
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
from repro.serving.engine import TransformerExecutor as JExecutor  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import hmp  # noqa: E402
from repro_torch.core.execplan import ExecPlan  # noqa: E402
from repro_torch.core.ring import LocalRing, ProcessRing  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import tiled_gemm as gemm_mod  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.models.sharding import Rules  # noqa: E402
from repro_torch.serving import graphs  # noqa: E402
from repro_torch.serving.engine import TransformerExecutor  # noqa: E402
from repro_torch.serving.galaxy import GalaxyHMPExecutor  # noqa: E402
from torch_helpers import CountingRuntime, NoHostReads, numpy_params  # noqa: E402

TOL = dict(atol=1e-4, rtol=0)


def test_dispatch_mode_catches_host_reads():
    t = torch.arange(4)
    for read in (lambda: t[0].item(), lambda: int(t.sum()), lambda: t.nonzero(),
                 lambda: t[t > 1], lambda: bool(t[1])):
        with pytest.raises(AssertionError, match="host read|boolean"), NoHostReads():
            read()


# --- the Galaxy step: uneven 4-device plan on LocalRing ------------------------------

SHARES = dict(heads=(6, 4, 4, 2), columns=(24, 16, 16, 8), head_dim=2, d_model=32,
              seq_shares=(3.0, 2.0, 2.0, 1.0))
ROWS = np.array([[3, 1, 5], [2, 6, 4], [0, 0, 0]])  # 3 pages of 8; slot 2 idle


@functools.lru_cache(maxsize=None)
def _galaxy_stack():
    """2 layers at d 32 (16 heads of 2, d_ff 64), vocab 50; two sequences of
    16 tokens and their full-context reference logits (causal: row p is
    what a decode step at position p gives)."""
    layers = jhmp.init_stack_params(jax.random.PRNGKey(0), 2, 32, 16, 64)
    emb = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (50, 32))) * 0.5
    tokens = np.random.default_rng(3).integers(1, 50, (2, 16))
    ref = np.asarray(jax.jit(jhmp.reference_stack)(layers, jnp.asarray(emb)[tokens]) @ emb.T)
    return layers, emb, tokens, ref


@pytest.mark.parametrize("backend", ["kernel", "eager"])
def test_galaxy_decode_step_reads_nothing_on_the_host(backend):
    """Slot 0 prefilled to 13 tokens, slot 1 to 6, slot 2 idle on the null
    page: three teacher-forced ``decode_paged`` steps under the dispatch
    mode, each live slot's logits the reference's at its position."""
    layers, emb, tokens, ref = _galaxy_stack()
    lt, et = hmp.params_from_numpy(layers, emb)
    ex = GalaxyHMPExecutor(lt, et, ExecPlan(**SHARES).with_backend(backend), LocalRing(4))
    assert not ex.graphs and ex.graph_stats is None
    pool = ex.make_pool(7, 8)
    lengths = (13, 6)
    for i, n in enumerate(lengths):
        logits, pool = ex.prefill_paged(tokens[i:i + 1, :n], pool, ROWS[i], length=n)
        np.testing.assert_allclose(logits.numpy()[0], ref[i, n - 1], **TOL)
    for step in range(3):
        pos = np.array([lengths[0] + step, lengths[1] + step, 0])
        tok = np.array([[tokens[0, pos[0]]], [tokens[1, pos[1]]], [0]])
        with NoHostReads():
            logits, pool = ex.decode_paged(tok, pool, ROWS, pos)
        for i in range(2):
            np.testing.assert_allclose(logits.numpy()[i], ref[i, pos[i]], **TOL)


# --- the zoo's step --------------------------------------------------------------------

PAGE, WIDTH = 8, 4
ZOO_ROWS = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]])  # slot 2 idle


def _zoo_steps(ex, tokens, lengths, steps, *, jex=None):
    """Prefill slots 0 and 1 (16 tokens each, real lengths ``lengths``),
    then ``steps`` decode steps of the three slots under the dispatch
    mode, fed ``tokens``; against ``jex``'s steps where given."""
    pool = ex.make_pool(1 + 2 * WIDTH, PAGE)
    jpool = None if jex is None else jex.make_pool(1 + 2 * WIDTH, PAGE)
    for i, n in enumerate(lengths):
        _, pool = ex.prefill_paged(tokens[i:i + 1, :16], pool, ZOO_ROWS[i], length=n)
        if jex is not None:
            _, jpool = jex.prefill_paged(jnp.asarray(tokens[i:i + 1, :16], jnp.int32), jpool,
                                         jnp.asarray(ZOO_ROWS[i], jnp.int32), length=n)
    for step in range(steps):
        pos = np.array([lengths[0] + step, lengths[1] + step, 0])
        tok = np.array([[tokens[0, 16 + step]], [tokens[1, 16 + step]], [0]])
        with NoHostReads():
            logits, pool = ex.decode_paged(tok, pool, ZOO_ROWS, pos)
        assert torch.isfinite(logits).all()
        if jex is not None:
            want, jpool = jex.decode_paged(jnp.asarray(tok, jnp.int32), jpool,
                                           jnp.asarray(ZOO_ROWS, jnp.int32),
                                           jnp.asarray(pos, jnp.int32))
            np.testing.assert_allclose(logits.numpy()[:2], np.asarray(want)[:2], **TOL)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "stablelm-12b"])
def test_zoo_decode_step_reads_nothing_and_matches_reference(arch):
    jcfg, cfg = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    if arch == "stablelm-12b":  # keep GQA under test
        jcfg = dataclasses.replace(jcfg, num_kv_heads=2)
        cfg = dataclasses.replace(cfg, num_kv_heads=2)
    tree = numpy_params(jcfg)
    ex = TransformerExecutor(params_from_numpy(tree), cfg)
    jex = JExecutor(jax.tree.map(jnp.asarray, tree), jcfg)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 19))
    _zoo_steps(ex, tokens, (13, 10), 3, jex=jex)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "granite-moe-3b-a800m"])
def test_moe_decode_step_reads_nothing_on_the_host(arch):
    """The MoE archs' routing, capacity and combine stay on the device."""
    cfg = reduced(get_config(arch))
    ex = TransformerExecutor(init_params(cfg, generator=torch.Generator().manual_seed(0)),
                             cfg)
    assert ex.supports_paged
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 18))
    _zoo_steps(ex, tokens, (13, 10), 2)


# --- what graphs=True refuses ------------------------------------------------------------

def test_graphs_refused_off_the_card_under_rules_and_across_processes():
    layers, emb, _, _ = _galaxy_stack()
    lt, et = hmp.params_from_numpy(layers, emb)
    plan = ExecPlan(**SHARES)
    with pytest.raises(ValueError, match="CUDA device"):
        GalaxyHMPExecutor(lt, et, plan, LocalRing(4), graphs=True)
    ex = GalaxyHMPExecutor(lt, et, plan, LocalRing(4))
    with pytest.raises(ValueError, match="CUDA device"):
        ex.graphs = True
    assert not ex.graphs
    ring = ProcessRing.__new__(ProcessRing)  # the type, without a process group
    ring.num_devices, ring.devices = 4, (1,)
    with pytest.raises(ValueError, match="ProcessRing"):
        GalaxyHMPExecutor(lt, et, plan, ring, graphs=True)

    cfg = reduced(get_config("qwen1.5-0.5b"))
    params = init_params(cfg, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="CUDA device"):
        TransformerExecutor(params, cfg, graphs=True)
    with pytest.raises(ValueError, match="rules"):
        TransformerExecutor(params, cfg, rules=Rules(), graphs=True)
    with pytest.raises(ValueError, match="on the card"):
        launch_serve.serve("qwen1.5-0.5b", executor_kind="zoo", reduce=True, device="cpu",
                           graphs=True)


@pytest.mark.parametrize("argv, why", [(["--ranks", "2"], "--ranks 2"),
                                       (["--device", "cpu"], "--device cpu")])
def test_serve_cli_refuses_cuda_graphs(argv, why, monkeypatch):
    def no_serve(*a, **k):
        raise AssertionError("served")

    monkeypatch.setattr(launch_serve, "serve", no_serve)
    monkeypatch.setattr(launch_serve, "launch_ranks", no_serve)
    with pytest.raises(SystemExit, match=why):
        launch_serve.main(["--model", "gpt2-l", "--reduce", "--cuda-graphs", *argv])


# --- StepGraph's bookkeeping, through a stand-in runtime ------------------------------

def test_step_graph_captures_once_a_pool_and_counts_replays():
    seen = []

    def step(pool, tokens, positions, block_table):
        """Three launches' worth of counts, and logits made of the inputs."""
        seen.append((tokens, positions, block_table))
        ops.KERNELS["tiled_gemm_valid"].launches += 3
        ops.KERNELS["tiled_gemm_valid"].paths["mma"] += 3
        pool["k"] += 1
        return (tokens + positions[:, None] + block_table.sum(1, keepdim=True)).float()

    ops.reset_launch_counts()
    rt = CountingRuntime()
    sg = graphs.StepGraph("cpu", runtime=rt)
    make = lambda: {"k": torch.zeros(2)}  # noqa: E731
    zero = lambda p: p["k"].zero_()  # noqa: E731
    pool = sg.paged_pool(3, 8, make, zero)
    tok, pos, bt = np.array([[5], [7]]), np.array([3, 0]), np.array([[1, 2], [0, 0]])
    out = sg.run(step, pool, tok, pos, bt)  # warm-up (the real step), then capture
    assert out.tolist() == [[11.0], [7.0]]
    stats = sg.stats["decode"]
    assert stats["captures"] == 1 and stats["replays"] == 0
    assert stats["pool_bytes"] == 4096
    assert ops.launch_counts()["tiled_gemm_valid"] == 3  # the warm-up's, not the capture's
    assert pool["k"].tolist() == [2.0, 2.0]  # warm-up and capture ran the step here
    bufs = seen[-1]  # what the captured step reads
    for k in range(1, 4):
        got = sg.run(step, pool, torch.tensor([[k], [k]]), pos, bt)  # host tensors too
        assert rt.graphs[0].replays == k and stats["replays"] == k
        assert bufs[0].tolist() == [[k], [k]] and bufs[1].tolist() == [3, 0]
        assert ops.launch_counts()["tiled_gemm_valid"] == 3 + 3 * k
        assert ops.path_counts()["tiled_gemm_valid"] == {"mma": 3 + 3 * k, "fma": 0}
        got.fill_(-1)  # a copy of the buffer: the next replay's is untouched
    assert len(seen) == 2 and sg.run(step, pool, tok, pos, bt).tolist() == [[11.0], [7.0]]

    with pytest.raises(ValueError, match="holds"):  # a pool it does not hold
        sg.run(step, make(), tok, pos, bt)
    other = sg.paged_pool(4, 8, make, zero)  # another geometry captures again
    sg.run(step, other, tok, pos, bt)
    assert stats["captures"] == 2 and len(rt.graphs) == 2
    sg.run(step, other, tok, pos, bt)
    assert rt.graphs[1].replays == 1 and rt.graphs[0].replays == 4
    sg.run(step, other, tok[:1], pos[:1], bt[:1])  # another slot count
    assert stats["captures"] == 3 and stats["replays"] == 5
    assert ops.launch_counts()["tiled_gemm_valid"] == 3 * (1 + 4 + 1 + 1 + 1)
    with pytest.raises(ValueError, match="lies on meta"):
        sg.run(step, other, torch.zeros((1, 1), dtype=torch.long, device="meta"),
               pos[:1], bt[:1])
    with pytest.raises(ValueError, match="CUDA device"):
        graphs.StepGraph("cpu")
    ops.reset_launch_counts()


# --- the capture guards --------------------------------------------------------------------

def test_no_workspace_growth_or_build_while_capturing(monkeypatch):
    monkeypatch.setattr(gemm_mod, "_workspaces", {})
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "build_all", lambda: pytest.fail("built while capturing"))
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    dev = torch.device("cpu", 0)
    ws, cnt = gemm_mod._workspace(dev, 64, 4)  # grown before the capture
    assert gemm_mod.workspaces() == ((ws, cnt),)
    capturing[0] = True
    assert gemm_mod._workspace(dev, 32, 2)[0] is ws  # large enough: no growth
    with pytest.raises(RuntimeError, match="warm up first"):
        gemm_mod._workspace(dev, 128, 4)
    with pytest.raises(RuntimeError, match="warm up first"):
        build.load("tiled_gemm_valid", {})
