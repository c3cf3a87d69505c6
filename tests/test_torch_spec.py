"""The port's speculative decoding (``serving/spec.py``) against the
reference's: the acceptance arithmetic, draft placement and expected-token
pricing on the same inputs; the engine contract of ``tests/test_spec.py``
(spec tokens == plain tokens, an identical draft accepts everything, the
flag errors) on the port's ``TransformerExecutor`` with reduced
qwen1.5-0.5b, tokens and speculative stats equal to the reference engine's
in-process; and the 4-device uneven 3:2:2:1 Galaxy target on
``LocalRing(4)`` with an unrelated zoo draft, both pools checked after
every round, at least one rejection and one acceptance, tokens equal to
spec off and to the reference's full-context greedy loop.

Weights are drawn with numpy (``test_torch_prefix_cache._numpy_params``,
or the reference's HMP initializer for the Galaxy stack) and carried to
both packages; greedy tokens are compared exactly.
"""
import functools

import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread, so the xdist workers beside it keep their cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.core import costmodel as jcost  # noqa: E402
from repro.core import hmp as jhmp  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro.serving import spec as jspec  # noqa: E402
from repro.serving.engine import TransformerExecutor as JExecutor  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import costmodel, hmp  # noqa: E402
from repro_torch.core.execplan import ExecPlan  # noqa: E402
from repro_torch.core.ring import LocalRing  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving import engine as eng_mod  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine, TransformerExecutor  # noqa: E402
from repro_torch.serving.galaxy import GalaxyHMPExecutor  # noqa: E402
from repro_torch.serving.sampler import SamplerConfig  # noqa: E402
from repro_torch.serving.spec import longest_accepted_prefix, place_draft  # noqa: E402
from test_torch_prefix_cache import _numpy_params  # noqa: E402

ARCH = "qwen1.5-0.5b"
SPEC_KEYS = ("spec_steps", "spec_proposed", "spec_accepted", "spec_accept_counts",
             "spec_acceptance", "decode_steps", "decode_tokens", "prefill_tokens")


# --- pure arithmetic, against the reference -------------------------------------

@pytest.mark.parametrize("proposed,verified", [
    ([], []), ([5, 6, 7], [5, 6, 7]), ([5, 6, 7], [5, 9, 7]), ([5, 6], [8, 6]),
    ([5, 6], [5, 6, 7]), ([np.int32(5)], np.asarray([5, 2])),
    ([3, 3, 3, 3], [3, 3, 3, 4, 9]),
])
def test_longest_accepted_prefix_matches_reference(proposed, verified):
    got = longest_accepted_prefix(proposed, verified)
    assert got == jspec.longest_accepted_prefix(proposed, verified)
    assert longest_accepted_prefix(proposed, torch.as_tensor(np.asarray(verified))) == got


def test_place_draft_matches_reference():
    rng = np.random.default_rng(0)
    for n in (1, 2, 4, 7):
        flops = rng.uniform(1e9, 9e9, n)
        devs = [costmodel.DeviceSpec(f"d{i}", float(f), 1e9, 1e9) for i, f in enumerate(flops)]
        jdevs = [jcost.DeviceSpec(f"d{i}", float(f), 1e9, 1e9) for i, f in enumerate(flops)]
        assert place_draft(devs) == jspec.place_draft(jdevs) == int(np.argmax(flops))
    with pytest.raises(ValueError):
        place_draft([])


def test_spec_expected_tokens_matches_reference():
    for a in (0.0, 0.3, 0.7, 0.95, 1.0):
        for k in (1, 2, 4, 8):
            assert costmodel.spec_expected_tokens(a, k) == pytest.approx(
                jcost.spec_expected_tokens(a, k), rel=1e-12)
    assert costmodel.spec_expected_tokens(0.0, 4) == 1.0
    assert costmodel.spec_expected_tokens(1.0, 4) == 5.0
    with pytest.raises(ValueError):
        costmodel.spec_expected_tokens(1.5, 4)
    with pytest.raises(ValueError):
        costmodel.spec_expected_tokens(0.5, 0)


# --- engine contract on the zoo executor, against the reference engine ------------

def _requests(req):
    return [req(uid=i, prompt=[1 + (i * 7 + j) % 200 for j in range(6 + 2 * i)],
                max_new_tokens=9 if i % 2 == 0 else 3)
            for i in range(5)]


@functools.lru_cache(maxsize=None)
def _zoo(seed):
    """The reduced qwen's weights from ``seed`` as both packages' executors."""
    jcfg, cfg = j_reduced(j_get_config(ARCH)), reduced(get_config(ARCH))
    tree = _numpy_params(jcfg, seed)
    return (JExecutor(jax.tree.map(jnp.asarray, tree), jcfg),
            TransformerExecutor(params_from_numpy(tree), cfg))


def _serve(make_engine, req, requests):
    eng = make_engine()
    for r in requests(req):
        eng.submit(r)
    return {r.uid: list(r.output) for r in eng.run()}, eng


@pytest.fixture(scope="module")
def zoo_runs():
    """Plain and speculative serves of the five requests (k 4, an unrelated
    draft) by both engines."""
    (jt, pt), (jd, pd) = _zoo(0), _zoo(9)
    kw = dict(max_batch=3, max_len=32, scheduler="continuous", page_size=4)
    out = {}
    for spec_on in (False, True):
        skw = dict(spec_k=4) if spec_on else {}
        out[spec_on] = (
            _serve(lambda: JEngine(executor=jt, draft_executor=jd if spec_on else None,
                                   **kw, **skw), JRequest, _requests),
            _serve(lambda: ServingEngine(pt, draft_executor=pd if spec_on else None,
                                         **kw, **skw), Request, _requests))
    return out


def test_spec_matches_plain_on_transformer_executor(zoo_runs):
    """Greedy tokens equal spec on and off with an unrelated draft (frequent
    rejections exercise the rollback), and equal the reference engine's."""
    (_, (plain, _)), ((jspec_out, jeng), (spec, eng)) = zoo_runs[False], zoo_runs[True]
    assert spec == plain == jspec_out
    stats = eng.stats
    assert stats["spec_steps"] > 0
    assert 0 <= stats["spec_accepted"] <= stats["spec_proposed"]
    assert sum(stats["spec_accept_counts"].values()) == stats["spec_steps"]
    assert stats["spec_acceptance"] == pytest.approx(
        stats["spec_accepted"] / max(stats["spec_proposed"], 1))
    for key in SPEC_KEYS:
        assert stats[key] == jeng.stats[key], key
    eng.pool.check()
    eng.spec.pool.check()


def test_plain_serve_matches_reference_engine(zoo_runs):
    (jplain, jeng), (plain, eng) = zoo_runs[False]
    assert plain == jplain
    assert eng.stats["spec_steps"] == 0 and eng.stats["spec_acceptance"] == 0.0
    assert eng.stats["spec_accept_counts"] == {} and eng.spec is None


def test_spec_identical_draft_accepts_everything():
    """Draft == target: every proposal accepted, rounds emit k + 1 tokens
    until the budget cap bites, and the tokens equal plain decoding."""
    _, target = _zoo(0)

    def one(req):
        return [req(uid=0, prompt=[1, 2, 3, 4, 5, 6], max_new_tokens=8)]

    kw = dict(max_batch=1, max_len=32, scheduler="continuous", page_size=4)
    done, eng = _serve(lambda: ServingEngine(target, draft_executor=target, spec_k=3,
                                             **kw), Request, one)
    assert len(done[0]) == 8
    assert eng.stats["spec_accepted"] == eng.stats["spec_proposed"] > 0
    assert eng.stats["spec_acceptance"] == 1.0
    ref, _ = _serve(lambda: ServingEngine(target, **kw), Request, one)
    assert ref == done


def test_spec_engine_validation():
    _, ex = _zoo(0)
    with pytest.raises(ValueError, match="both draft_executor and spec_k"):
        ServingEngine(ex, max_batch=1, max_len=16, spec_k=4)
    with pytest.raises(ValueError, match="both draft_executor and spec_k"):
        ServingEngine(ex, max_batch=1, max_len=16, draft_executor=ex)
    with pytest.raises(ValueError, match="continuous"):
        ServingEngine(ex, max_batch=1, max_len=16, scheduler="wave",
                      draft_executor=ex, spec_k=4)
    with pytest.raises(ValueError, match="greedy-only"):
        ServingEngine(ex, max_batch=1, max_len=16,
                      sampler=SamplerConfig(temperature=0.8), draft_executor=ex, spec_k=4)
    with pytest.raises(ValueError, match="spec_k must be >= 1"):
        ServingEngine(ex, max_batch=1, max_len=16, draft_executor=ex, spec_k=0)

    class NoChunk:
        supports_paged = True

    with pytest.raises(ValueError, match="prefill_chunk protocol"):
        ServingEngine(NoChunk(), draft_executor=ex, spec_k=2)
    with pytest.raises(ValueError, match="paged protocol"):
        ServingEngine(ex, draft_executor=object(), spec_k=2)


# --- 4-device uneven Galaxy target: rollback and pool invariants ----------------

PLAN = ExecPlan(heads=(6, 4, 4, 2), columns=(24, 16, 16, 8), head_dim=2,
                d_model=32, seq_shares=(3.0, 2.0, 2.0, 1.0))


def _galaxy_requests(req):
    return [req(uid=i, prompt=[1 + (i * 5 + j) % 250 for j in range(6 + 3 * i)],
                max_new_tokens=10 if i % 2 == 0 else 4)
            for i in range(5)]


@functools.lru_cache(maxsize=None)
def _galaxy_case():
    """The reference test's stack (2 layers, d 32, 16 heads, d_ff 64, vocab
    300) and its full-context greedy tokens (jitted once on a padded
    length; causal, so each row's logits are exact)."""
    layers = jhmp.init_stack_params(jax.random.PRNGKey(0), 2, 32, 16, 64)
    emb = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (300, 32))) * 0.5

    @jax.jit
    def logits(tokens):
        return jhmp.reference_stack(layers, jnp.asarray(emb)[tokens]) @ emb.T

    want = {}
    for r in _galaxy_requests(Request):
        toks = list(r.prompt)
        for _ in range(r.max_new_tokens):
            padded = np.zeros((1, 32), np.int32)
            padded[0, :len(toks)] = toks
            toks.append(int(np.argmax(np.asarray(logits(padded))[0, len(toks) - 1])))
        want[r.uid] = toks[len(r.prompt):]
    return layers, emb, want


@functools.lru_cache(maxsize=None)
def _galaxy_draft():
    """The reference test's draft: reduced qwen1.5-0.5b from the reference's
    initializer at key 3 (vocab 512 covers the target's 300)."""
    from repro.models import init_params

    jcfg = j_reduced(j_get_config(ARCH))
    tree = jax.tree.map(np.asarray, init_params(jcfg, jax.random.PRNGKey(3)))
    return TransformerExecutor(params_from_numpy(tree), reduced(get_config(ARCH)))


@pytest.mark.parametrize("backend", ["eager", "kernel"])
def test_spec_galaxy_uneven_4dev_with_rollback(backend, monkeypatch):
    """A 3:2:2:1 Galaxy target verifying an unrelated one-device draft's
    proposals: ``check()`` on both pools after every round, at least one
    rejection and one acceptance, tokens equal to spec off and to the
    reference's full-context greedy loop."""
    layers, emb, want = _galaxy_case()
    lt, et = hmp.params_from_numpy(layers, emb)
    target = GalaxyHMPExecutor(lt, et, PLAN.with_backend(backend), LocalRing(4))
    draft = _galaxy_draft()
    orig, rounds = eng_mod.run_spec_round, [0]

    def checked(engine, spec, slots, live, pool, storage):
        out = orig(engine, spec, slots, live, pool, storage)
        pool.check()
        spec.pool.check()
        rounds[0] += 1
        return out

    monkeypatch.setattr(eng_mod, "run_spec_round", checked)
    kw = dict(max_batch=2, max_len=40, scheduler="continuous", page_size=8)
    plain, _ = _serve(lambda: ServingEngine(target, **kw), Request, _galaxy_requests)
    spec, eng = _serve(lambda: ServingEngine(target, draft_executor=draft, spec_k=4, **kw),
                       Request, _galaxy_requests)
    assert spec == plain == want
    st = eng.stats
    # spec_steps counts per-slot verify chunks; a round covers up to max_batch
    assert 0 < rounds[0] <= st["spec_steps"] <= 2 * rounds[0]
    assert st["spec_proposed"] > st["spec_accepted"] > 0, st
    assert any(c < 4 for c in st["spec_accept_counts"]), "rollback never ran"
    eng.pool.check()
    eng.spec.pool.check()
    assert eng.pool.free_pages == eng.pool.num_pages - 1
    assert eng.spec.pool.free_pages == eng.spec.pool.num_pages - 1
