"""The zoo executor under the HMP sharding rules on two gloo ranks
(``TransformerExecutor(rules=)``, ``serve --executor zoo --ranks``)
against the unsharded port executor and the reference's
``TransformerExecutor`` and engine.

One module fixture starts the two ranks of ``tests/torch_zoo_ranks_worker.py``
once on a (data 1, model 2) mesh under ``make_rules(mesh, "prefill")``.
They run, for five reduced archs (recurrentgemma-9b with a window of 8,
shorter than the prompt; qwen1.5-0.5b; qwen with 3 query heads on 1 KV
head, whose heads do not divide the model axis, so the queries go
sequence-sharded; granite-moe-3b-a800m; xlstm-350m): the sharded init
against ``init_params``, and on both backends a prefill of a right-padded
batch with ``lengths`` and 4 lockstep decode steps, on the reference's
weights carried over through numpy.  For the archs the zoo pages (qwen,
qwen-3-heads, granite, StableLM kept GQA with 2 KV heads, and qwen with 4
query heads on 1 KV head, whose KV heads do not split where the query
heads do), on both backends, the paged protocol: a one-shot
``prefill_paged`` of a bucket-padded prompt, ``prefill_chunk`` at
page-aligned offsets and at an unaligned one, a prefix-hit suffix over
shared pages, and 4 ``decode_paged`` steps of 3 slots at their own depths
beside an idle slot on the null page; the collectives its calls stage.
Then the engine on the mesh: waves greedy and at temperature 0.8, the
continuous scheduler, with the prefix cache and chunks, and speculative
decoding with the draft on rank 0.  The reference runs in this process
while the ranks work, each executor jitted once per shape, under
``make_rules`` on a one-device JAX mesh.

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
#: the paged cases: StableLM kept GQA as ``tests/test_torch_dense_zoo.py``
#: keeps it, and one KV head under four query heads
PAGED_CASES = [
    {"name": "stablelm-12b", "arch": "stablelm-12b", "over": {"num_kv_heads": 2}},
    {"name": "qwen-1-kv-head", "arch": "qwen1.5-0.5b", "over": {"num_kv_heads": 1}},
]
PAGED = ["qwen1.5-0.5b", "qwen-3-heads", "granite-moe-3b-a800m", "stablelm-12b",
         "qwen-1-kv-head"]
#: the paged cases held to the reference as well (the last is held to the
#: unsharded port, which the others hold to the reference)
PAGED_REF = PAGED[:4]
B, S, LENGTHS, STEPS = 3, 16, [16, 11, 7], 4
#: the paged calls: pages of 4, 8 a row; prompt a of 13 tokens padded to
#: 16, in chunks of 8; another 8-token chunk at offset 13 (where a verify
#: chunk goes); b shares a's first 8 tokens (2 pages) and is 14 long
PAGE, WIDTH, CHUNK, SHARED, LEN_A, LEN_B = 4, 8, 8, 8, 13, 14
#: the engine's traffic: three waves' worth of same-length prompts, and
#: the same tails behind a shared 16-token prompt for the prefix cache
PROMPT_LENS, MAX_BATCH, MAX_NEW = [12, 12, 12, 9, 9], 3, 5
MAX_LEN = max(PROMPT_LENS) + MAX_NEW
PREFIX_LEN, SERVE_PAGE, SERVE_CHUNK = 16, 8, 8
SERVES = [("recurrentgemma-9b", 0.0, "wave"), ("qwen1.5-0.5b", 0.0, "auto"),
          ("recurrentgemma-9b", 0.8, "wave")]
#: the continuous serves beside them: the prefix cache with chunks, and
#: speculative decoding, k 2, drafted on rank 0 by reduced qwen of other
#: weights (spec off: the "auto" serve)
PREFIX_SERVE = dict(name="qwen1.5-0.5b", temperature=0.0, scheduler="continuous",
                    page_size=SERVE_PAGE, prefix_cache=True, prefill_chunk=SERVE_CHUNK,
                    max_len=PREFIX_LEN + MAX_LEN, prompts="prefix_prompts", one=True)
SPEC_SERVE = dict(name="qwen1.5-0.5b", temperature=0.0, scheduler="auto", spec_k=2,
                  max_len=MAX_LEN, prompts="prompts", one=True)
VOCAB = 512  # every reduced arch's vocabulary, the bound of the drawn ids


def _env():
    """The ranks' environment: the port on the path, one thread a process
    (tiny shapes, bound by the host's dispatch; the test workers beside
    them keep their cores)."""
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _case(name):
    return next(c for c in CASES + PAGED_CASES if c["name"] == name)


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


def _reference_paged(jp, jcfg, rules, pg):
    """The reference executor's paged calls, those of the worker's
    ``paged_calls``: each call's logits, then the pool's leaves."""
    ex = JExecutor(jp, jcfg, rules)
    a, b, verify = np.array([pg["a"]]), np.array([pg["b"]]), np.array([pg["verify"]])
    pool = ex.make_pool(1 + 3 * WIDTH, PAGE)
    rows = [list(range(1 + i * WIDTH, 1 + (i + 1) * WIDTH)) for i in range(3)]
    rows[2][:SHARED // PAGE] = rows[0][:SHARED // PAGE]
    rows = [np.array(r, np.int32) for r in rows]
    outs = []
    out, pool = ex.prefill_paged(a, pool, rows[0], LEN_A)
    outs.append(np.asarray(out))
    for off in range(0, a.shape[1], CHUNK):
        out, pool = ex.prefill_chunk(a[:, off:off + CHUNK], pool, rows[1], offset=off,
                                     length=LEN_A)
        outs.append(np.asarray(out))
    out, pool = ex.prefill_chunk(verify, pool, rows[1], offset=LEN_A,
                                 length=LEN_A + verify.shape[1])
    outs.append(np.asarray(out))
    out, pool = ex.prefill_chunk(b[:, SHARED:], pool, rows[2], offset=SHARED, length=LEN_B)
    outs.append(np.asarray(out))
    table = np.array(rows + [np.zeros(WIDTH, np.int32)])
    pos = np.array([LEN_A, LEN_A + verify.shape[1], LEN_B, 0], np.int32)
    for step in pg["steps"]:
        out, pool = ex.decode_paged(np.array(step)[:, None], pool, table, pos)
        outs.append(np.asarray(out))
        pos = pos + (pos > 0)
    return outs, {key: np.asarray(leaf) for key, leaf in flat_tree(pool).items()}


def _reference_serve(jp, jcfg, rules, prompts, max_len, **kw):
    eng = JEngine(jp, jcfg, max_batch=MAX_BATCH, max_len=max_len, rules=rules, **kw)
    for i, prompt in enumerate(prompts):
        eng.submit(JRequest(uid=i, prompt=prompt, max_new_tokens=MAX_NEW))
    return {str(r.uid): r.output for r in eng.run()}


def _serves():
    """{key: serve} of the engine's serves (``SERVES``, then the prefix and
    speculative ones) as the worker takes them."""
    out = {f"{name}@{t}@{sched}": dict(name=name, temperature=t, scheduler=sched,
                                        max_len=MAX_LEN, prompts="prompts",
                                        one=sched == "auto")
           for name, t, sched in SERVES}
    out["prefix"], out["spec"] = PREFIX_SERVE, SPEC_SERVE
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' results and the reference's, computed while the
    ranks run: {"ranks": [report per rank], "logits": [npz per rank],
    "ref": {case: logits}, "ref_paged": {case: (logits, pool)},
    "ref_tokens": {serve: tokens}}."""
    tmp = tmp_path_factory.mktemp("zoo_ranks")
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, VOCAB, (B, S))
    steps = rng.integers(0, VOCAB, (STEPS, B)).tolist()
    prompts = [rng.integers(0, VOCAB, n).tolist() for n in PROMPT_LENS]
    shared = rng.integers(0, VOCAB, PREFIX_LEN).tolist()
    a = rng.integers(0, VOCAB, LEN_A).tolist()
    pg = {"names": PAGED, "page": PAGE, "width": WIDTH, "chunk": CHUNK, "shared": SHARED,
          "len_a": LEN_A, "len_b": LEN_B, "a": a + [0] * (-LEN_A % CHUNK),
          "b": a[:SHARED] + rng.integers(0, VOCAB, LEN_B - SHARED).tolist()
          + [0] * (-LEN_B % CHUNK),
          "verify": rng.integers(0, VOCAB, CHUNK).tolist(),
          "steps": rng.integers(0, VOCAB, (STEPS, 4)).tolist()}
    trees = {}
    for i, case in enumerate(CASES + PAGED_CASES):
        trees[case["name"]] = numpy_params(_jcfg(case), seed=10 + i)
        np.savez(tmp / f"{case['name']}.npz", **flat_tree(trees[case["name"]]))
    spec = {"cases": CASES + PAGED_CASES, "wave_names": NAMES, "paged": pg,
            "tokens": tokens.tolist(), "lengths": LENGTHS, "steps": steps,
            "prompts": prompts, "prefix_prompts": [shared + p for p in prompts],
            "max_batch": MAX_BATCH, "max_new": MAX_NEW, "serves": _serves(),
            "draft": "qwen1.5-0.5b", "paged_case": "qwen1.5-0.5b"}
    (tmp / "inputs.json").write_text(json.dumps(spec))
    port = _free_port()
    env = _env()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_zoo_ranks_worker.py"),
                               str(r), str(port), str(tmp)], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        rules = j_make_rules(j_make_test_mesh(model=1, data=1), "prefill")
        ref, ref_paged, ref_tokens = {}, {}, {}
        for case in CASES + PAGED_CASES:
            name, jcfg = case["name"], _jcfg(case)
            jp = jax.tree.map(jax.numpy.asarray, trees[name])
            if name in NAMES:
                ref[name] = _reference(jp, jcfg, rules, tokens, steps)
            if name in PAGED_REF:
                ref_paged[name] = _reference_paged(jp, jcfg, rules, pg)
            for key, sv in spec["serves"].items():
                if sv["name"] == name and sv["temperature"] == 0.0 and "spec_k" not in sv:
                    kw = {k: sv[k] for k in ("page_size", "prefix_cache", "prefill_chunk")
                          if k in sv}
                    ref_tokens[key] = _reference_serve(jp, jcfg, rules, spec[sv["prompts"]],
                                                       sv["max_len"], scheduler=sv["scheduler"],
                                                       **kw)
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return {"ranks": [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)],
            "logits": [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)],
            "ref": ref, "ref_paged": ref_paged, "ref_tokens": ref_tokens}


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
    """The engine on the mesh: greedy tokens equal to the reference
    engine's (``scheduler="auto"`` resolves to the continuous scheduler for
    qwen, which the zoo pages, and to waves for RecurrentGemma), the paged
    serve's also to one process's, the sampled ones equal on both ranks,
    and varied."""
    reps = ranks["ranks"]
    for name, temperature, scheduler in SERVES:
        key = f"{name}@{temperature}@{scheduler}"
        got = reps[0]["serves"][f"mesh:{key}"]
        assert reps[1]["serves"][f"mesh:{key}"] == got
        paged = scheduler == "auto" and name in PAGED
        assert got["stats"]["prefill_waves"] == (0 if paged else 2)
        assert got["stats"]["prefill_oneshots"] == (len(PROMPT_LENS) if paged else 0)
        assert got["pool_checked"] is paged
        assert all(len(t) == MAX_NEW for t in got["tokens"].values())
        if paged:
            assert got["tokens"] == reps[0]["serves"][f"one:{key}"]["tokens"]
        if temperature == 0.0:
            assert got["tokens"] == ranks["ref_tokens"][key], key
        else:
            greedy = reps[0]["serves"][f"mesh:{name}@0.0@wave"]["tokens"]
            assert got["tokens"] != greedy


def _paged(ranks, r, name, backend, where):
    logits = ranks["logits"][r]
    n = sum(k.startswith(f"{name}/{backend}/{where}/paged") for k in logits)
    pool = {k.split("/pool/")[1]: v for k, v in logits.items()
            if k.startswith(f"{name}/{backend}/{where}/pool/")}
    return [logits[f"{name}/{backend}/{where}/paged{i}"] for i in range(n)], pool


#: the paged calls of the worker's ``paged_calls``: the one-shot prefill,
#: two aligned chunks, the unaligned chunk, the prefix-hit suffix, then the
#: decode steps (3 live slots and the idle one)
PAGED_SHAPES = [(1, VOCAB)] + [(1, CHUNK, VOCAB)] * 4 + [(4, VOCAB)] * STEPS


@pytest.mark.parametrize("backend", ["kernel", "eager"])
@pytest.mark.parametrize("name", PAGED)
def test_paged_protocol_under_rules_equals_unsharded(ranks, name, backend):
    """``prefill_paged``, ``prefill_chunk`` (aligned and unaligned offsets,
    a prefix-hit suffix) and ``decode_paged`` (per-slot depths, an idle
    slot) on the mesh give the unsharded executor's logits within 1e-5 of
    its largest, bitwise the same on both ranks, and the pool's pages,
    gathered whole, hold the unsharded pool's K/V on every page but the
    null page."""
    one, one_pool = _paged(ranks, 0, name, backend, "one")
    assert [o.shape for o in one] == PAGED_SHAPES
    base, _ = _paged(ranks, 0, name, backend, "mesh")
    for r in range(2):
        mesh, pool = _paged(ranks, r, name, backend, "mesh")
        for i, (got, want, b0) in enumerate(zip(mesh, one, base)):
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), (name, i)
            np.testing.assert_array_equal(got, b0)
        assert pool.keys() == one_pool.keys()
        for key, leaf in pool.items():
            want = one_pool[key][:, 1:]
            assert np.abs(leaf[:, 1:] - want).max() <= 1e-5 * np.abs(want).max(), key


@pytest.mark.parametrize("backend", ["kernel", "eager"])
@pytest.mark.parametrize("name", PAGED_REF)
def test_paged_protocol_under_rules_matches_reference(ranks, name, backend):
    """The same calls against the reference's paged calls under its rules,
    logits and the pool's pages (but the null page), atol = rtol = 1e-4."""
    mesh, pool = _paged(ranks, 0, name, backend, "mesh")
    ref, ref_pool = ranks["ref_paged"][name]
    for i, (got, want) in enumerate(zip(mesh, ref)):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4, err_msg=f"call {i}")
    for key, leaf in pool.items():
        np.testing.assert_allclose(leaf[:, 1:], ref_pool[key][:, 1:], atol=1e-4, rtol=1e-4,
                                   err_msg=key)


@pytest.mark.parametrize("name", PAGED)
def test_paged_calls_run_the_kernel_on_local_shards(ranks, name):
    """On the kernel backend under the mesh each paged prefill call (the
    one-shot, three chunks, the prefix-hit suffix) reaches the flash
    kernel's wrapper once a layer, with this rank's half of the query heads
    (or of the rows where the heads do not divide), and no decode step
    reaches it; on the eager backend none does."""
    cfg = _jcfg(_case(name))
    layers = cfg.layer_kinds().count("attn")
    for rep in ranks["ranks"]:
        calls = rep[name]["kernel_paged_calls"]["flash_attention"]
        assert sum(n for _, n in calls) == 5 * layers
        assert rep[name]["eager_paged_calls"]["flash_attention"] == []
        heads_split = cfg.num_heads % 2 == 0
        rows = sorted(sig[0][2] for sig, n in calls for _ in range(n // layers))
        if heads_split:
            assert {sig[0][1] for sig, _ in calls} == {cfg.num_heads // 2}
            assert rows == [CHUNK] * 4 + [2 * CHUNK]
        else:
            assert {sig[0][1] for sig, _ in calls} == {cfg.num_heads}
            assert rows == [CHUNK // 2] * 4 + [CHUNK]


@pytest.mark.parametrize("name", PAGED)
def test_paged_calls_stage_the_collectives_of_a_wave_step(ranks, name):
    """``CommDebugMode`` on the mesh: a page gather and a page scatter issue
    no collective (each rank holds every page of its KV heads), and a
    ``decode_paged`` step of four slots at their own depths issues exactly
    the collectives of a lockstep ``decode`` step of the same batch."""
    for rep in ranks["ranks"]:
        comms = rep[name]["comms"]
        assert comms["gather"] == comms["scatter"] == {}
        assert comms["decode_paged"] == comms["decode"]
        assert sum(comms["decode"].values()) > 0


def test_continuous_engine_with_prefix_cache_and_chunks_on_the_mesh(ranks):
    """The continuous scheduler with the prefix cache and chunks on the
    mesh: greedy tokens equal to the one-process port's and the reference
    engine's, stats equal to one process's (prefix hits, cached tokens,
    chunks), the same on both ranks, the pool's refcounts checked."""
    reps = ranks["ranks"]
    got = reps[0]["serves"]["mesh:prefix"]
    one = reps[0]["serves"]["one:prefix"]
    assert reps[1]["serves"]["mesh:prefix"] == got
    assert got["pool_checked"] and got["tokens"] == one["tokens"]
    assert got["tokens"] == ranks["ref_tokens"]["prefix"]
    assert got["stats"] == one["stats"]
    assert got["stats"]["prefix_hits"] >= 1 and got["stats"]["prefill_chunks"] >= 2
    assert got["stats"]["cached_prefix_tokens"] >= PREFIX_LEN


def test_spec_engine_on_the_mesh(ranks):
    """Speculative decoding on the mesh, the draft (reduced qwen, k 2) on
    rank 0 alone: greedy tokens equal to spec off's on the mesh (the
    reference engine's) and to the one-process spec serve's, the stats
    equal on both ranks and to one process's, at least one verify chunk."""
    reps = ranks["ranks"]
    got = reps[0]["serves"]["mesh:spec"]
    off = reps[0]["serves"]["mesh:qwen1.5-0.5b@0.0@auto"]["tokens"]
    assert reps[1]["serves"]["mesh:spec"] == got
    assert got["pool_checked"] and got["tokens"] == off
    assert got["tokens"] == reps[0]["serves"]["one:spec"]["tokens"]
    assert got["stats"] == reps[0]["serves"]["one:spec"]["stats"]
    assert got["stats"]["spec_steps"] >= 1


@pytest.mark.parametrize("call", ["make_pool", "prefill_paged", "prefill_chunk",
                                  "decode_paged", "continuous"])
def test_mesh_refuses_the_paged_protocol(ranks, call):
    """Under a mesh the executor has the paged protocol, call by call (the
    test keeps the name of the slice that refused it): ``supports_paged``
    is True for qwen; ``make_pool`` places each leaf's KV heads on the
    model axis, every page on each rank; each prefill and decode call gives
    finite logits of its shape with the pool so placed; the continuous
    scheduler takes the executor."""
    cfg = _jcfg(_case("qwen1.5-0.5b"))
    leaf = {"shape": [cfg.num_groups, 4, 4, cfg.num_kv_heads, cfg.head_dim],
            "placements": ["R", "S(3)"],
            "local": [cfg.num_groups, 4, 4, cfg.num_kv_heads // 2, cfg.head_dim]}
    shapes = {"prefill_paged": [1, VOCAB], "prefill_chunk": [1, 1, VOCAB],
              "decode_paged": [1, VOCAB]}
    for rep in ranks["ranks"]:
        got = rep["paged_calls"]
        assert got["supports_paged"] is True
        if call == "make_pool":
            assert got[call] == leaf
        elif call == "continuous":
            assert got[call] == {"scheduler": "continuous", "supports_paged": True}
        else:
            assert got[call] == {"shape": shapes[call], "finite": True, "pool": leaf}


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

def _cli_args(tmp, *args):
    return ["--executor", "zoo", "--reduce", "--device", "cpu", "--report", str(tmp), *args]


def _start_cli(tmp, *args):
    """``launch.serve --executor zoo --reduce --device cpu --report tmp``
    with ``args``, started as a user starts it."""
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve",
                             *_cli_args(tmp, *args)],
                            env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _serve_line(stdout):
    return next(json.loads(t) for t in stdout.splitlines() if t.startswith('{"ranks"'))


def _reports(tmp):
    return [json.loads(p.read_text()) for p in sorted(Path(tmp).glob("rank*.json"))]


def _finish_cli(proc, tmp):
    """The serve line and every rank's report of a started serve (and its
    standard output)."""
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err[-3000:]
    return _serve_line(out), _reports(tmp), out


def _one_process_cli(tmp, capsys, *args):
    """The same command's one-process serve, run in this process (as
    ``launch.serve``'s ``main`` runs it): its serve line and report."""
    capsys.readouterr()
    launch_serve.main(_cli_args(tmp, *args))
    (rep,) = _reports(tmp)
    return _serve_line(capsys.readouterr().out), rep


RGEMMA_CLI = ("--model", "recurrentgemma-9b", "--prompt-lens", "40,40,33", "--max-new", "4")


def test_serve_cli_zoo_on_two_ranks_equals_one_process(tmp_path, capsys):
    """``launch.serve --executor zoo --model recurrentgemma-9b --reduce
    --device cpu --ranks 2`` serves the tokens one process serves (prompts
    of 40 tokens, past the reduced window of 32), on both ranks, in waves,
    with each rank's kernel calls on its own half of the heads and of the
    recurrence columns and half the weights.  (The one-process serve runs
    in this process while the ranks work.)"""
    proc = _start_cli(tmp_path / "two", *RGEMMA_CLI, "--ranks", "2")
    line1, one = _one_process_cli(tmp_path / "one", capsys, *RGEMMA_CLI)
    line2, reps, _ = _finish_cli(proc, tmp_path / "two")
    assert (line2["ranks"], line2["transport"]) == (2, "gloo")
    assert line2["stats"] == line1["stats"] and line2["stats"]["prefill_waves"] == 2
    for rep in reps:
        assert rep["tokens"] == one["tokens"]
        assert rep["weight_bytes"] < one["weight_bytes"]
        assert rep["pool"] is None
        heads = {sig[0][1] for sig, _ in rep["kernel_calls"]["flash_attention"]}
        widths = {sig[0][2] for sig, _ in rep["kernel_calls"]["rglru_scan"]}
        assert heads == {sig[0][1] // 2 for sig, _ in one["kernel_calls"]["flash_attention"]}
        assert widths == {sig[0][2] // 2 for sig, _ in one["kernel_calls"]["rglru_scan"]}


#: the continuous serve across ranks: 4 requests behind a shared prompt,
#: two slots (so the later two hit the prefix cache), chunks of 16
QWEN_CLI = ("--model", "qwen1.5-0.5b", "--requests", "4", "--prompt-len", "20-40",
            "--max-new", "4", "--max-batch", "2", "--prefix-cache", "on",
            "--prefill-chunk", "16")


def test_serve_cli_zoo_continuous_on_two_ranks_equals_one_process(tmp_path, capsys):
    """``launch.serve --executor zoo --model qwen1.5-0.5b --reduce --device
    cpu --ranks 2 --prefix-cache on --prefill-chunk 16`` serves by
    continuous batching through the prefix cache and chunks: every rank's
    tokens and stats equal to one process's serve of the same arguments,
    prefix hits and chunks among them, and each rank holding half the
    pool's bytes (half the KV heads, every page).  With ``--trace``,
    ``--metrics`` and ``--drift`` across the ranks rank 0 writes the trace
    and prints the registry and the drift summary."""
    trace = tmp_path / "trace.json"
    proc = _start_cli(tmp_path / "two", *QWEN_CLI, "--ranks", "2", "--trace", str(trace),
                      "--metrics", "--drift")
    line1, one = _one_process_cli(tmp_path / "one", capsys, *QWEN_CLI)
    line2, reps, stdout = _finish_cli(proc, tmp_path / "two")
    assert (line2["ranks"], line2["transport"]) == (2, "gloo")
    spans = {e["name"] for e in json.loads(trace.read_text())["traceEvents"] if e["ph"] == "X"}
    assert {"prefix_lookup", "prefill_chunk", "decode_step"} <= spans
    assert "metrics snapshot:" in stdout and "  prefill_chunk: n=" in stdout
    stats = line1["stats"]
    assert line2["stats"] == stats and stats["prefill_waves"] == 0
    assert stats["prefix_hits"] >= 1 and stats["prefill_chunks"] >= 1
    assert len(reps) == 2
    for rep in reps:
        assert rep["tokens"] == one["tokens"]
        assert rep["stats"] == one["stats"]
        assert rep["pool"] == dict(one["pool"], bytes=one["pool"]["bytes"] // 2)


@pytest.mark.parametrize("extra,match", [
    pytest.param(["--model", "qwen1.5-0.5b", "--scheduler", "continuous"], None,
                 id="extra0-one process"),
    pytest.param(["--model", "qwen1.5-0.5b", "--scheduler", "auto"], None,
                 id="extra1-one process"),
    pytest.param(["--model", "recurrentgemma-9b", "--scheduler", "continuous"],
                 "across ranks as on one process", id="extra2-one process"),
    pytest.param(["--model", "qwen1.5-0.5b", "--draft-model", "qwen1.5-0.5b", "--spec-k", "2"],
                 None, id="extra3-speculative decoding, the prefix cache and chunked prefill"),
    pytest.param(["--model", "qwen1.5-0.5b", "--prefix-cache", "on", "--prefill-chunk", "16"],
                 None, id="extra4-speculative decoding, the prefix cache and chunked prefill"),
])
def test_serve_refuses_zoo_continuous_across_ranks(extra, match, monkeypatch):
    """What ``--ranks`` refuses before any rank starts is what one process
    refuses: the continuous scheduler on RecurrentGemma (``match``).  The
    zoo's continuous scheduler on qwen (asked for, or ``auto``),
    speculative decoding, the prefix cache and chunks pass to the ranks'
    launch (``match`` None; the launch is recorded, not run)."""
    started = []
    monkeypatch.setattr(launch_serve.rank_procs, "launch",
                        lambda cmd, n, **kw: started.append((cmd, n)))
    argv = ["--executor", "zoo", "--reduce", "--device", "cpu", "--ranks", "2", *extra]
    if match is None:
        launch_serve.main(argv)
        (cmd, n), = started
        assert n == 2 and cmd[-len(extra):] == extra
    else:
        with pytest.raises(SystemExit, match=match):
            launch_serve.main(argv)
        assert started == []
