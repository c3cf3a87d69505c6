"""The Galaxy program on a ``ProcessRing``: four gloo ranks on the CPU, one
process per ring device, each holding only its own shards.

One module-scoped fixture starts the four ranks once
(``tests/torch_ring_worker.py``); they run every case and save their
results, which the tests here hold against the reference package and
against a ``LocalRing`` run of the same case made inside rank 0's process:

* the ring primitives: a partial ``permute`` (exact zeros where nothing
  arrives), a hop posted and waited on later, ``psum``, ``all_gather``,
  ``agree`` from rank 0 and from rank 2, and bucketed segments, bitwise
  against ``LocalRing``;
* ``hmp_layer`` on the uneven 3:2:2:1 plan of ``tests/test_torch_hmp.py``
  at s 16 and 13, every combination of backend, overlap, transport and
  double buffering; ``megatron_layer`` and ``sp_layer``;
* ``ServingEngine`` over the ``GalaxyHMPExecutor`` (max_batch 3,
  continuous, prefix cache with chunks of 8, waves): greedy tokens;
* speculative decoding, the uneven Galaxy case of
  ``tests/test_torch_spec.py`` (its 2-layer stack, its reduced
  qwen1.5-0.5b draft from the reference's initializer, k 4) with the
  draft on device 2's rank only, both pools checked after every round:
  tokens equal to the reference's full-context greedy loop and to the
  ``LocalRing`` spec serve, equal stats on every rank;
* the same serve with chunks, traced under a tick clock and drift priced
  on rank 0 alone: its trace events and drift records equal the
  ``LocalRing`` serve's.

Tolerances: layer outputs within 2e-5 of the reference's
``reference_layer`` on valid rows, the bound of ``tests/test_torch_hmp.py``
(PyTorch's and XLA's CPU matmuls sum in different orders).  Against
``LocalRing`` every output is bitwise equal: each rank computes its
device's shard exactly as ``LocalRing`` does, and ``psum`` adds in device
order on both.  The ranks run with one thread each, as does rank 0's
``LocalRing`` run (a CPU GEMM's bits can depend on the thread count).
Tokens are compared exactly (greedy argmax over fp32 logits whose top-2
gap is far wider than their error).

Also here: the rank launcher stops the ranks and fails when one rank fails
or they outlive their time limit; ``launch.serve --ranks`` refuses the zoo
executor and a rank count that is not the plan's; the kernel build's file
lock compiles a source once when four processes start together;
``launch.serve --ranks 4 --device cpu`` end to end with speculative
decoding, ``--trace``, ``--metrics`` and ``--drift``; and
``launch.ring_times --ranks 4 --device cpu``.
"""
import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread, so the xdist workers beside it keep their cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import hmp as jhmp  # noqa: E402
from repro_torch.launch import ranks  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_ring_worker as worker  # noqa: E402
from test_torch_spec import _galaxy_case, _galaxy_requests  # noqa: E402

PLAN = worker.PLAN


@functools.lru_cache(maxsize=None)
def _layer_case():
    p = jhmp.init_layer_params(jax.random.PRNGKey(0), 32, 16, 64)
    xs = {s: np.random.default_rng(s).normal(size=(2, s, 32)).astype(np.float32) * 0.5
          for s in (16, 13)}
    ref = jax.jit(jhmp.reference_layer)
    return p, xs, {s: np.asarray(ref(p, jnp.asarray(x))) for s, x in xs.items()}


@functools.lru_cache(maxsize=None)
def _serving_case():
    """A 2-layer stack (d 32, 16 heads of 2, d_ff 64, vocab 50), 4 prompts
    behind a 16-token shared system prompt (2 pages of 8), and their
    full-context greedy tokens (jitted once on a padded length)."""
    stack = jhmp.init_stack_params(jax.random.PRNGKey(0), 2, 32, 16, 64)
    emb = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (50, 32))) * 0.5
    sysp = list(range(1, 17))
    prompts = [sysp + [20 + i, 21, 22 + i, 23] for i in range(4)]

    @jax.jit
    def logits(tokens):
        return jhmp.reference_stack(stack, jnp.asarray(emb)[tokens]) @ emb.T

    want = {}
    for uid, pr in enumerate(prompts):
        toks = list(pr)
        for _ in range(3 + uid):
            padded = np.zeros((1, 32), np.int32)
            padded[0, :len(toks)] = toks
            toks.append(int(np.argmax(np.asarray(logits(padded))[0, len(toks) - 1])))
        want[uid] = toks[len(pr):]
    return stack, emb, prompts, want


#: ``launch.serve --ranks 4`` on the CPU, at the reduced GPT2-L, with a
#: speculative draft and the three telemetry flags
CLI_ARGV = ["--model", "gpt2-l", "--reduce", "--device", "cpu", "--requests", "3",
            "--prompt-len", "20-40", "--max-new", "3", "--prefix-cache", "on",
            "--prefill-chunk", "16", "--draft-model", "distilbert", "--spec-k", "2",
            "--metrics", "--drift"]


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """``launch.serve --ranks 4`` started (its own four ranks beside the
    fixture below's, so the two overlap); the tests take its result."""
    tmp = tmp_path_factory.mktemp("serve_ranks")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve", *CLI_ARGV,
                             "--trace", str(tmp / "trace.json"), "--ranks", "4",
                             "--rank-timeout", "60", "--report", str(tmp)],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        yield proc, tmp
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def cli_result(cli_run):
    """The CLI run's standard output, its serve line and every rank's
    report (it failed the test if the run failed)."""
    proc, tmp = cli_run
    stdout, stderr = proc.communicate(timeout=90)
    assert proc.returncode == 0, stderr[-3000:]
    line = next(json.loads(t) for t in stdout.splitlines() if t.startswith('{"ranks"'))
    reps = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(4)]
    return stdout, line, reps, tmp


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory, cli_run):
    """Every case run once on four gloo ranks; [rank] -> results."""
    tmp = tmp_path_factory.mktemp("process_ring")
    p, xs, _ = _layer_case()
    stack, emb, prompts, _ = _serving_case()
    arrays = {f"layer/{k}": np.asarray(v) for k, v in p.items()}
    arrays.update({f"x{s}": x for s, x in xs.items()})
    for i, layer in enumerate(stack):
        arrays.update({f"stack{i}/{k}": np.asarray(v) for k, v in layer.items()})
    arrays.update({f"prompt{i}": np.asarray(pr) for i, pr in enumerate(prompts)})
    arrays.update(emb=emb, n_stack=np.asarray(len(stack)), n_prompts=np.asarray(len(prompts)))
    arrays.update(_spec_arrays())
    np.savez(tmp / "inputs.npz", **arrays)
    ranks.launch([sys.executable, str(ROOT / "tests" / "torch_ring_worker.py"),
                  str(tmp / "inputs.npz"), str(tmp)], 4, timeout=90, capture=True)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(4)]


def _spec_arrays():
    """The speculative cases' inputs: ``tests/test_torch_spec.py``'s
    Galaxy stack and requests, and its draft's weights from the
    reference's initializer (reduced qwen1.5-0.5b at key 3), flattened."""
    from repro.configs import get_config as j_get_config
    from repro.configs import reduced as j_reduced
    from repro.models import init_params

    layers, emb, _ = _galaxy_case()
    reqs = _galaxy_requests(Request)
    tree = init_params(j_reduced(j_get_config(worker.DRAFT_ARCH)), jax.random.PRNGKey(3))
    arrays = {"draft/" + "/".join(k.key for k in path): np.asarray(leaf)
              for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    for i, layer in enumerate(layers):
        arrays.update({f"spec_stack{i}/{k}": np.asarray(v) for k, v in layer.items()})
    arrays.update({f"spec_prompt{r.uid}": np.asarray(r.prompt) for r in reqs})
    arrays.update(spec_emb=emb, spec_n_stack=np.asarray(len(layers)),
                  spec_max_new=np.asarray([r.max_new_tokens for r in reqs]))
    return arrays


# --- the ring primitives ----------------------------------------------------------

@pytest.mark.parametrize("what", ["permute_partial", "permute_async", "psum", "all_gather",
                                  "agree", "agree_src", "bucketed_ship"])
def test_ring_primitive_equals_local_ring(rank_results, what):
    for r, res in enumerate(rank_results):
        got, want = res["primitives"][what]
        assert torch.equal(got, want), (what, r, got, want)
    if what == "permute_partial":  # ranks 0 and 2 are no destination
        for r in (0, 2):
            got, _ = rank_results[r]["primitives"][what]
            assert not got.any()


# --- layers -------------------------------------------------------------------------

@pytest.mark.parametrize("case", worker.LAYER_CASES,
                         ids=["-".join(map(str, c)) for c in worker.LAYER_CASES])
def test_hmp_layer_on_four_ranks(rank_results, case):
    """Every rank's ``hmp_layer`` output (gathered over the ring) is within
    2e-5 of ``reference_layer`` on valid rows and bitwise equal to the
    ``LocalRing`` run."""
    s = case[0]
    _, _, refs = _layer_case()
    local = rank_results[0]["layers"][case][1]
    lay = PLAN.seq_layout(s)
    for r, res in enumerate(rank_results):
        y = res["layers"][case][0]
        assert torch.equal(y, local), (case, r)
        np.testing.assert_allclose(lay.gather(y).numpy(), refs[s], atol=2e-5, rtol=0)


@pytest.mark.parametrize("name", ["megatron_uneven_eager", "megatron_uneven_kernel",
                                  "megatron_even", "sp"])
def test_baseline_schedules_on_four_ranks(rank_results, name):
    _, _, refs = _layer_case()
    local = rank_results[0]["layers"][name][1]
    for r, res in enumerate(rank_results):
        y = res["layers"][name][0]
        assert torch.equal(y, local), (name, r)
        np.testing.assert_allclose(y.numpy(), refs[16], atol=2e-5, rtol=0)


# --- serving ------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(worker.ENGINE_MODES))
@pytest.mark.parametrize("backend", ["eager", "kernel"])
def test_engine_on_four_ranks_matches_reference(rank_results, backend, mode):
    """The four ranks' engines serve the reference's greedy tokens, the
    same as a ``LocalRing`` engine's, with equal stats on every rank; each
    rank holds one layer shard and one pool shard."""
    _, _, _, want = _serving_case()
    local = rank_results[0]["engines"][(backend, mode)]["local"]
    assert local["tokens"] == want
    assert (local["layer_shards"], local["pool_shards"]) == (4, 4)
    for r, res in enumerate(rank_results):
        got = res["engines"][(backend, mode)]["process"]
        assert got["tokens"] == want, (r, got["tokens"])
        assert got["stats"] == local["stats"], r
        assert (got["layer_shards"], got["pool_shards"]) == (1, 1)
    if mode == "prefix_chunked":
        st = local["stats"]
        assert st["prefix_hits"] >= 1 and st["prefill_chunks"] >= 4


@pytest.mark.parametrize("backend", ["eager", "kernel"])
def test_spec_on_four_ranks_matches_reference(rank_results, backend):
    """The uneven Galaxy spec serve with the draft on device 2's rank: the
    reference's full-context greedy tokens on every rank and on
    ``LocalRing``, equal stats everywhere, at least one rejection, both
    pools checked after every round and empty at the end, and the draft's
    pool and calls on rank 2 alone."""
    *_, want = _galaxy_case()
    local = rank_results[0]["spec"][backend]["local"]
    assert local["tokens"] == want and not local["errors"]
    st = local["stats"]
    assert 0 < local["rounds"] <= st["spec_steps"]
    assert st["spec_proposed"] > st["spec_accepted"] > 0, st
    assert any(c < 4 for c in st["spec_accept_counts"]), "rollback never ran"
    for r, res in enumerate(rank_results):
        got = res["spec"][backend]["process"]
        assert got["tokens"] == want, (r, got["tokens"])
        assert got["stats"] == st, r
        assert got["rounds"] == local["rounds"] and not got["errors"], (r, got["errors"])
        assert got["free"], r
        if r == worker.DRAFT_DEVICE:
            assert got["draft"] == local["draft"] and got["draft"]["free"]
            assert got["draft"]["prefills"] == len(want)
        else:
            assert got["draft"] is None, r


# --- the launcher, its refusals, the build lock, the CLI ------------------------------

_FAILS = """
import sys, torch.distributed as dist
from repro_torch.launch import ranks
a = sys.argv
rank, init = int(a[a.index('--rank') + 1]), a[a.index('--init-method') + 1]
ranks.init(rank, 3, init, device='cpu', timeout=60)
if rank == 1:
    sys.exit(3)
dist.barrier()  # the others wait for rank 1 here
"""


@pytest.mark.parametrize("fault", ["rank_fails", "timeout"])
def test_launch_stops_the_ranks_and_fails(fault):
    """A rank that fails stops the others at once, and ranks that outlive
    the time limit are stopped: either way the launch raises."""
    if fault == "rank_fails":
        # rank 1's exit may be seen first, or rank 0's, whose barrier lost its peer
        cmd, timeout, match = [sys.executable, "-c", _FAILS], 60, "rank [01] of 3 exited"
    else:
        cmd, timeout, match = [sys.executable, "-c", "import time; time.sleep(60)"], 1, \
            "did not finish"
    t0 = time.monotonic()
    with pytest.raises(ranks.RankFailure, match=match):
        ranks.launch(cmd, 3, timeout=timeout, capture=True)
    assert time.monotonic() - t0 < 40


@pytest.mark.parametrize("extra,match", [
    (["--ranks", "3"], "does not match the plan's 4 devices"),
    (["--ranks", "0"], "must be >= 1"),
    (["--ranks", "4", "--executor", "zoo", "--model", "recurrentgemma-9b", "--scheduler",
      "continuous"], "one process"),
])
def test_serve_refuses_across_ranks(extra, match):
    """Checked before any rank starts: a ring the plan does not have, and
    what one process refuses too (the zoo's continuous scheduler on an arch
    it serves in waves)."""
    argv = ["--model", "gpt2-l", "--reduce", "--device", "cpu", *extra]
    with pytest.raises(SystemExit, match=match):
        launch_serve.main(argv)


@pytest.mark.parametrize("flag", ["trace", "metrics", "drift", "draft-model"])
def test_serve_cli_features_across_ranks(cli_result, flag):
    """The one ``launch.serve --ranks 4`` run with ``--draft-model``,
    ``--trace``, ``--metrics`` and ``--drift``: rank 0 writes a trace with
    no open span (the export refuses one) and prints the metrics and the
    drift summary; the draft runs on the rank ``place_draft`` names, and
    every rank serves the same tokens with the same stats and counters."""
    stdout, line, reps, tmp = cli_result
    if flag == "trace":
        events = json.loads((tmp / "trace.json").read_text())["traceEvents"]
        assert f"trace: {sum(e['ph'] != 'M' for e in events)} events -> " in stdout
        assert {"queued", "prefill_chunk", "spec_round", "draft_propose", "spec_verify"} <= {
            e["name"] for e in events if e["ph"] == "X"}
    elif flag == "metrics":
        assert "metrics snapshot:" in stdout and "repro_ttft_s_count 3" in stdout
        assert f"repro_spec_steps_total {line['stats']['spec_steps']}" in stdout
        assert all(rep["counters"] == reps[0]["counters"] for rep in reps)
        assert reps[0]["counters"]["spec_steps"] == line["stats"]["spec_steps"]
    elif flag == "drift":
        assert "sim-vs-measured drift" in stdout
        assert "  spec_verify: n=" in stdout and "  prefill_chunk: n=" in stdout
    else:
        st = reps[0]["stats"]
        assert st["spec_steps"] > 0 and line["stats"] == st
        where = line["draft_device"]
        assert where == launch_serve.draft_placement("galaxy", (3, 2, 2, 1))
        for r, rep in enumerate(reps):
            assert rep["tokens"] == reps[0]["tokens"] and rep["stats"] == st, r
            assert rep["draft_device"] == where
            assert (rep["draft"] is not None) == (r == where), r
        assert reps[where]["draft"]["prefills"] == 3


@pytest.mark.parametrize("what", ["tracer", "drift", "spec"])
def test_engine_serves_one_process_features_across_ranks(rank_results, what):
    """The chunked spec serve, traced and drift priced on rank 0 alone:
    rank 0's trace events (tick clock) and drift records equal the
    ``LocalRing`` serve's, and every rank serves the reference's tokens
    with the same stats and registry counters."""
    local = rank_results[0]["telemetry"]["local"]
    first = rank_results[0]["telemetry"]["process"]
    if what == "tracer":
        assert first["open_spans"] == [] and first["events"] == local["events"]
        assert {"prefill_chunk", "spec_round", "draft_propose", "spec_verify"} <= {
            e["name"] for e in first["events"]}
    elif what == "drift":
        assert first["drift"] == local["drift"]
        assert {d["kind"] for d in first["drift"]} == {"prefill_chunk", "spec_verify"}
    else:
        *_, want = _galaxy_case()
        assert local["tokens"] == want and local["stats"]["spec_steps"] > 0
        assert local["stats"]["prefill_chunks"] > 0
    for r, res in enumerate(rank_results):
        got = res["telemetry"]["process"]
        assert got["tokens"] == local["tokens"], r
        assert got["stats"] == local["stats"] and got["counters"] == local["counters"], r
        assert got["ttft_n"] == len(local["tokens"]), r
        if r:
            assert got["events"] is None and got["drift"] is None


class _SplitRing:
    num_devices, devices = 4, (1,)


class _Executor:
    supports_paged = True
    ring = _SplitRing()

    def prefill_chunk(self, *a, **k):
        raise AssertionError


@pytest.mark.parametrize("kw,match", [
    (dict(draft_executor=_Executor(), spec_k=2), "draft's device index"),
    (dict(draft_executor=_Executor(), spec_k=2, draft_device=2), "rank of device 2 alone"),
    (dict(spec_k=2, draft_device=1), "rank of device 1 alone"),
])
def test_engine_places_the_draft_on_its_rank(kw, match):
    """On a ring of processes the engine needs the draft's device, and a
    draft executor exactly on that device's rank."""
    with pytest.raises(ValueError, match=match):
        ServingEngine(_Executor(), **kw)


_FAKE_NVCC = """#!/bin/sh
sleep 0.5
echo built >> "{count}"
out=""
while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done
: > "$out"
"""

_BUILD = """
import sys
from pathlib import Path
from repro_torch.kernels import build
build.BUILD_DIR = Path(sys.argv[1])
build.SOURCES = ("fused_connective",)
print(sorted(build.build_all()))
"""


def test_kernel_build_lock_builds_once_across_processes(tmp_path):
    """Four processes that start together compile a source once: the file
    lock makes the others wait and find the library built."""
    count = tmp_path / "count"
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(_FAKE_NVCC.format(count=count))
    nvcc.chmod(0o755)
    env = dict(os.environ, PATH=f"{nvcc.parent}{os.pathsep}{os.environ['PATH']}",
               PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path / "_build")],
                              env=env, stdout=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=60)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert count.read_text().splitlines() == ["built"]
    assert sorted(o.strip() for o in outs) == ["['fused_connective']", "[]", "[]", "[]"]


def test_serve_cli_on_four_ranks_equals_local_ring(cli_result, rank_results):
    """``launch.serve --ranks 4 --device cpu`` serves what one process on a
    ``LocalRing`` serves with the same arguments; rank 0 prints the serve
    line with the rank count and the transport, and every rank reports its
    hops."""
    _, line, reps, _ = cli_result
    assert (line["ranks"], line["transport"]) == (4, "gloo")
    out = launch_serve.serve("gpt2-l", (3, 2, 2, 1), reduce=True, device="cpu", requests=3,
                             prompt_len=(20, 40), max_new=3, prefix_cache=True,
                             prefill_chunk=16, draft_model="distilbert", spec_k=2)
    want = {str(r.uid): r.output for r in out["requests"]}
    assert line["stats"] == json.loads(json.dumps(out["stats"]))
    for r, rep in enumerate(reps):
        assert rep["tokens"] == want, r
        assert rep["hops"] > 0 and rep["routes"] == {"direct": rep["hops"]}


def test_ring_times_on_four_cpu_ranks():
    """``launch.ring_times --ranks 4 --device cpu`` times the hop and the
    prefill under the ring with and without double buffering and under
    the sync schedule; all three give the same logits to rounding."""
    from repro_torch.configs import get_config, reduced
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.ring_times",
                           "--ranks", "4", "--device", "cpu", "--reduce", "--seq", "64",
                           "--timeout", "60"],
                          env=env, capture_output=True, text=True, timeout=90)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    d = reduced(get_config("gpt2-l")).d_model
    assert (res["ranks"], res["seq"], res["dtype"]) == (4, 64, "float32")
    assert [rr["rank"] for rr in res["per_rank"]] == [0, 1, 2, 3]
    for rr in res["per_rank"]:
        assert rr["hop_bytes"] == res["pad_tile"] * d * 4
        assert set(rr["routes"]) == {"direct"}
        assert 0 < rr["hop_ms_min"] <= rr["hop_ms"]
        assert set(rr["prefill_ms"]) == {"ring", "ring_double_buffer", "sync"}
        assert all(ms > 0 for ms in rr["prefill_ms"].values())
        assert set(rr["logit_err_vs_sync"]) == {"ring", "ring_double_buffer"}
        assert all(err < 1e-5 for err in rr["logit_err_vs_sync"].values()), rr
