"""The zoo executor under the HMP sharding rules on two gloo ranks
(``TransformerExecutor(rules=)``, ``serve --executor zoo --ranks``)
against the unsharded port executor and the reference's
``TransformerExecutor`` and wave engine.

One module fixture starts the two ranks of ``tests/torch_zoo_ranks_worker.py``
once on a (data 1, model 2) mesh under ``make_rules(mesh, "prefill")``.
They run, for five reduced archs (recurrentgemma-9b with a window of 8,
shorter than the prompt; qwen1.5-0.5b; qwen with 3 query heads on 1 KV
head, whose heads do not divide the model axis, so the queries go
sequence-sharded; granite-moe-3b-a800m; xlstm-350m): the sharded init
against ``init_params``, and on both backends a prefill of a right-padded
batch with ``lengths`` and 4 lockstep decode steps, on the reference's
weights carried over through numpy.  Then the wave engine on the mesh,
greedy and at temperature 0.8, and the paged protocol's refusals.  The
reference runs in this process while the ranks work, each executor
jitted once per shape, under ``make_rules`` on a one-device JAX mesh.

Tolerances: the sharded logits within 1e-5 of the largest unsharded
logit (fp32; only sums split over the ranks add in another order); the
reference's within atol = rtol = 1e-4, as ``tests/test_torch_zoo.py``
(the port's flash attention and sequential scan sum in another order than
the reference's jnp attention and associative scan).  Tokens exactly.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.launch.mesh import make_test_mesh as j_make_test_mesh  # noqa: E402
from repro.models.sharding import make_rules as j_make_rules  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro.serving.engine import TransformerExecutor as JExecutor  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from torch_helpers import flat_tree, numpy_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

CASES = [
    {"name": "recurrentgemma-9b", "arch": "recurrentgemma-9b", "over": {"window": 8}},
    {"name": "qwen1.5-0.5b", "arch": "qwen1.5-0.5b", "over": {}},
    {"name": "qwen-3-heads", "arch": "qwen1.5-0.5b", "over": {"num_heads": 3, "num_kv_heads": 1}},
    {"name": "granite-moe-3b-a800m", "arch": "granite-moe-3b-a800m", "over": {}},
    {"name": "xlstm-350m", "arch": "xlstm-350m", "over": {}},
]
NAMES = [c["name"] for c in CASES]
B, S, LENGTHS, STEPS = 3, 16, [16, 11, 7], 4
#: the engine's traffic: three waves' worth of same-length prompts
PROMPT_LENS, MAX_BATCH, MAX_NEW = [12, 12, 12, 9, 9], 3, 5
MAX_LEN = max(PROMPT_LENS) + MAX_NEW
SERVES = [("recurrentgemma-9b", 0.0, "wave"), ("qwen1.5-0.5b", 0.0, "auto"),
          ("recurrentgemma-9b", 0.8, "wave")]
VOCAB = 512  # every reduced arch's vocabulary, the bound of the drawn ids


def _env():
    """The ranks' environment: the port on the path, two threads a process
    (tiny shapes; the test workers beside them keep their cores)."""
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _jcfg(case):
    return dataclasses.replace(j_reduced(j_get_config(case["arch"])), **case["over"])


def _reference(jp, jcfg, rules, tokens, steps):
    """The reference executor's logits: the prefill with ``lengths``, then
    each lockstep decode step."""
    ex = JExecutor(jp, jcfg, rules)
    cache = ex.make_cache(B, S + STEPS)
    out, cache = ex.prefill(tokens, cache, np.array(LENGTHS))
    outs = [np.asarray(out)]
    for i, step in enumerate(steps):
        out, cache = ex.decode(np.array(step)[:, None], cache, S + i)
        outs.append(np.asarray(out))
    return np.stack(outs)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' results and the reference's, computed while the
    ranks run: {"ranks": [report per rank], "logits": [npz per rank],
    "ref": {case: logits}, "ref_tokens": {arch: tokens}, "prompts": [...]}."""
    tmp = tmp_path_factory.mktemp("zoo_ranks")
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, VOCAB, (B, S))
    steps = rng.integers(0, VOCAB, (STEPS, B)).tolist()
    prompts = [rng.integers(0, VOCAB, n).tolist() for n in PROMPT_LENS]
    trees = {}
    for i, case in enumerate(CASES):
        trees[case["name"]] = numpy_params(_jcfg(case), seed=10 + i)
        np.savez(tmp / f"{case['name']}.npz", **flat_tree(trees[case["name"]]))
    (tmp / "inputs.json").write_text(json.dumps({
        "cases": CASES, "tokens": tokens.tolist(), "lengths": LENGTHS, "steps": steps,
        "prompts": prompts, "max_batch": MAX_BATCH, "max_len": MAX_LEN, "max_new": MAX_NEW,
        "serves": SERVES, "paged_case": "qwen1.5-0.5b"}))
    port = _free_port()
    env = _env()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_zoo_ranks_worker.py"),
                               str(r), str(port), str(tmp)], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        rules = j_make_rules(j_make_test_mesh(model=1, data=1), "prefill")
        ref, ref_tokens = {}, {}
        for case in CASES:
            jp = jax.tree.map(jax.numpy.asarray, trees[case["name"]])
            ref[case["name"]] = _reference(jp, _jcfg(case), rules, tokens, steps)
            if any(name == case["name"] and t == 0.0 for name, t, _ in SERVES):
                eng = JEngine(jp, _jcfg(case), max_batch=MAX_BATCH, max_len=MAX_LEN,
                              rules=rules, scheduler="wave")
                for i, prompt in enumerate(prompts):
                    eng.submit(JRequest(uid=i, prompt=prompt, max_new_tokens=MAX_NEW))
                ref_tokens[case["name"]] = {str(r.uid): r.output for r in eng.run()}
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return {"ranks": [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)],
            "logits": [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)],
            "ref": ref, "ref_tokens": ref_tokens}


def test_sharded_init_equals_init_params(ranks):
    """``init_params(rules=)``: every leaf's ``full_tensor()`` bitwise equal
    to ``init_params``' leaf, each rank holding less than the whole."""
    for rep in ranks["ranks"]:
        for name in NAMES:
            assert rep[name]["init_unequal"] == [], name
            assert rep[name]["init_local_bytes"] < rep[name]["init_bytes"], name


@pytest.mark.parametrize("backend", ["kernel", "eager"])
@pytest.mark.parametrize("name", NAMES)
def test_wave_protocol_under_rules_equals_unsharded(ranks, name, backend):
    """Prefill with ``lengths`` and 4 lockstep decode steps on the mesh give
    the unsharded executor's logits within 1e-5 of its largest, bitwise
    the same on both ranks."""
    one = ranks["logits"][0][f"{name}/{backend}/one"]
    tol = 1e-5 * np.abs(one).max()
    for logits in ranks["logits"]:
        mesh = logits[f"{name}/{backend}/mesh"]
        assert mesh.shape == (1 + STEPS, B, one.shape[-1])
        assert np.abs(mesh - one).max() <= tol
    np.testing.assert_array_equal(ranks["logits"][0][f"{name}/{backend}/mesh"],
                                  ranks["logits"][1][f"{name}/{backend}/mesh"])


@pytest.mark.parametrize("backend", ["kernel", "eager"])
@pytest.mark.parametrize("name", NAMES)
def test_wave_protocol_under_rules_matches_reference(ranks, name, backend):
    """The same calls against the reference's ``TransformerExecutor`` under
    its rules, atol = rtol = 1e-4."""
    np.testing.assert_allclose(ranks["logits"][0][f"{name}/{backend}/mesh"],
                               ranks["ref"][name], atol=1e-4, rtol=1e-4)


def _layers(name):
    cfg = _jcfg(next(c for c in CASES if c["name"] == name))
    kinds = cfg.layer_kinds()
    return cfg, kinds.count("attn"), kinds.count("rec")


@pytest.mark.parametrize("name", NAMES)
def test_kernel_backend_runs_the_kernels_on_local_shards(ranks, name):
    """On the kernel backend under the mesh every attention layer's prefill
    reaches the flash kernel's wrapper and every RG-LRU layer's the scan's,
    with this rank's plain shards (half the heads, or half the queries
    where the heads do not divide; half the recurrence columns), and the
    log-depth scan never runs; on the eager backend no wrapper is reached
    and the log-depth scan runs once per RG-LRU layer.  (On CPU tensors
    the wrappers run their plain versions; on the card they launch.)"""
    cfg, attn, rec = _layers(name)
    for rep in ranks["ranks"]:
        kern, eager = rep[name]["kernel_calls"], rep[name]["eager_calls"]
        assert sum(n for _, n in kern["flash_attention"]) == attn
        assert sum(n for _, n in kern["rglru_scan"]) == rec
        assert kern["log_depth_scan"] == []
        assert eager["flash_attention"] == eager["rglru_scan"] == []
        assert len(eager["log_depth_scan"]) == rec
        heads_split = cfg.num_heads % 2 == 0
        for sig, _ in kern["flash_attention"]:
            assert sig[0] == ([B, cfg.num_heads // 2, S, cfg.head_dim] if heads_split
                              else [B, cfg.num_heads, S // 2, cfg.head_dim])
        for sig, _ in kern["rglru_scan"]:
            assert sig[0] == [B, S, cfg.lru_width // 2]


def test_wave_engine_on_the_mesh(ranks):
    """The wave engine on the mesh: greedy tokens equal to the reference
    engine's (``scheduler="auto"`` resolves to waves for qwen, which the
    zoo pages on one process), the sampled ones equal on both ranks, and
    varied."""
    reps = ranks["ranks"]
    for name, temperature, scheduler in SERVES:
        key = f"{name}@{temperature}@{scheduler}"
        got = reps[0]["serves"][key]
        assert reps[1]["serves"][key] == got
        assert got["prefill_waves"] == 2
        assert all(len(t) == MAX_NEW for t in got["tokens"].values())
        if temperature == 0.0:
            assert got["tokens"] == ranks["ref_tokens"][name], key
        else:
            greedy = reps[0]["serves"][f"{name}@0.0@wave"]["tokens"]
            assert got["tokens"] != greedy


@pytest.mark.parametrize("call", ["make_pool", "prefill_paged", "prefill_chunk",
                                  "decode_paged", "continuous"])
def test_mesh_refuses_the_paged_protocol(ranks, call):
    """Under a mesh the executor has no paged protocol: ``supports_paged``
    is False (qwen pages on one process), each paged call raises
    ``NotImplementedError`` naming the next slice, and the continuous
    scheduler is refused."""
    for rep in ranks["ranks"]:
        ref = rep["refusals"]
        assert ref["supports_paged"] is False
        if call == "continuous":
            assert ref[call] == ("ValueError: the continuous scheduler needs the paged "
                                 "executor protocol")
        else:
            assert ref[call].startswith(f"NotImplementedError: {call}: the paged protocol "
                                        f"under a mesh: next slice")


def test_staged_collectives_on_gloo_only(ranks):
    """``core/ring.stage_mesh_collectives``' kernels, called on CPU tensors:
    over the gloo group each gives what the collective gives unstaged and
    is counted once with the bytes this rank sent; over a group of another
    backend the collective runs as torch registers it, uncounted."""
    for rep in ranks["ranks"]:
        staged = rep["staged"]
        assert staged["equal"] == dict.fromkeys(staged["equal"], True)
        assert len(staged["equal"]) == 6
        assert staged["counts"] == {name: [1, 32] for name in staged["equal"]}
        assert staged["fake_counted"] == 0


# --- the entry point ---------------------------------------------------------------

def _serve_cli(tmp, *extra):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--executor", "zoo", "--model",
         "recurrentgemma-9b", "--reduce", "--device", "cpu", "--prompt-lens", "40,40,33",
         "--max-new", "4", "--report", str(tmp), *extra],
        env=_env(), cwd=ROOT, capture_output=True,
        text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(json.loads(t) for t in out.stdout.splitlines() if t.startswith('{"ranks"'))
    return line, [json.loads(p.read_text()) for p in sorted(Path(tmp).glob("rank*.json"))]


def test_serve_cli_zoo_on_two_ranks_equals_one_process(tmp_path):
    """``launch.serve --executor zoo --model recurrentgemma-9b --reduce
    --device cpu --ranks 2`` serves the tokens one process serves (prompts
    of 40 tokens, past the reduced window of 32), on both ranks, in waves,
    with each rank's kernel calls on its own half of the heads and of the
    recurrence columns and half the weights."""
    line1, (one,) = _serve_cli(tmp_path / "one")
    line2, reps = _serve_cli(tmp_path / "two", "--ranks", "2")
    assert (line2["ranks"], line2["transport"]) == (2, "gloo")
    assert line2["stats"] == line1["stats"] and line2["stats"]["prefill_waves"] == 2
    for rep in reps:
        assert rep["tokens"] == one["tokens"]
        assert rep["weight_bytes"] < one["weight_bytes"]
        heads = {sig[0][1] for sig, _ in rep["kernel_calls"]["flash_attention"]}
        widths = {sig[0][2] for sig, _ in rep["kernel_calls"]["rglru_scan"]}
        assert heads == {sig[0][1] // 2 for sig, _ in one["kernel_calls"]["flash_attention"]}
        assert widths == {sig[0][2] // 2 for sig, _ in one["kernel_calls"]["rglru_scan"]}


@pytest.mark.parametrize("extra,match", [
    (["--model", "qwen1.5-0.5b", "--scheduler", "continuous"], "one process"),
    (["--model", "qwen1.5-0.5b", "--scheduler", "auto"], "one process"),
    (["--model", "recurrentgemma-9b", "--scheduler", "continuous"], "one process"),
    (["--model", "recurrentgemma-9b", "--draft-model", "recurrentgemma-9b", "--spec-k", "2"],
     "speculative decoding, the prefix cache and chunked prefill"),
    (["--model", "recurrentgemma-9b", "--prefix-cache", "on"],
     "speculative decoding, the prefix cache and chunked prefill"),
])
def test_serve_refuses_zoo_continuous_across_ranks(extra, match):
    """The zoo's continuous scheduler (asked for, or ``auto`` on an arch it
    pages), speculative decoding and the prefix cache are refused with
    ``--ranks`` before any rank starts."""
    argv = ["--executor", "zoo", "--reduce", "--device", "cpu", "--ranks", "2", *extra]
    with pytest.raises(SystemExit, match=match):
        launch_serve.main(argv)
