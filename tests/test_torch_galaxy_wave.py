"""The Galaxy executor's wave protocol and the paper's baselines against the
reference, on the uneven 3:2:2:1 plan of ``tests/test_execplan.py``
(heads 6/4/4/2, columns 24/16/16/8, sequence shares 3:2:2:1) over
``LocalRing(4)``.

* Wave serving (``make_cache`` / ``prefill`` / ``decode`` over the dense
  per-wave cache): greedy tokens equal the reference's full-context greedy
  loop, for both backends, with waves that mix prompt lengths.
* ``SCHEDULES`` (``hmp``, ``hmp_ring``, ``megatron``, ``sp``): each layer
  output against the reference's ``reference_layer`` at S 16 and 13, both
  backends, under the uneven plan where the schedule takes one (SP
  replicates its weights, so it runs the even split).

Tolerance: fp32, 2e-5 on layer outputs (the bound of the reference's own
uneven-plan test); tokens exactly.
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
from repro_torch.core import hmp  # noqa: E402
from repro_torch.core.execplan import ExecPlan  # noqa: E402
from repro_torch.core.ring import LocalRing  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.galaxy import GalaxyHMPExecutor  # noqa: E402

PLAN = ExecPlan(heads=(6, 4, 4, 2), columns=(24, 16, 16, 8), head_dim=2,
                d_model=32, seq_shares=(3.0, 2.0, 2.0, 1.0))
RING = LocalRing(4)
PROMPTS = [[1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], [4, 7, 1, 9, 2, 8, 3, 6, 5, 10, 12],
           [3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8], [5, 5, 3, 8, 1, 2, 9, 9, 4]]


# --- wave serving ----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_tokens():
    """Full-context greedy loop over the reference stack (jitted once on a
    right-padded length; causal, so each row's logits are exact)."""
    layers = jhmp.init_stack_params(jax.random.PRNGKey(1), 2, 32, 16, 64)
    emb = np.asarray(jax.random.normal(jax.random.PRNGKey(8), (50, 32))) * 0.5

    @jax.jit
    def logits(tokens):
        return jhmp.reference_stack(layers, jnp.asarray(emb)[tokens]) @ emb.T

    out = []
    for uid, pr in enumerate(PROMPTS):
        toks = list(pr)
        for _ in range(2 + uid):
            padded = np.zeros((1, 24), np.int32)
            padded[0, :len(toks)] = toks
            toks.append(int(np.argmax(np.asarray(logits(padded))[0, len(toks) - 1])))
        out.append(toks[len(pr):])
    return layers, emb, out


def _executor(backend):
    layers, emb, _ = _reference_tokens()
    lt, et = hmp.params_from_numpy(layers, emb)
    return GalaxyHMPExecutor(lt, et, PLAN.with_backend(backend), RING)


@pytest.mark.parametrize("backend", ["eager", "kernel"])
def test_wave_serving_matches_reference_greedy(backend):
    """Waves of up to 3 same-bucket prompts (the two 11-token prompts share
    one; 8 and 9 tokens share the bucket of 12): greedy tokens equal the
    reference for every request, and equal the continuous scheduler's."""
    _, _, expected = _reference_tokens()
    ex = _executor(backend)
    done = {}
    for sched in ("wave", "continuous"):
        eng = ServingEngine(ex, max_batch=3, max_len=24, page_size=8, scheduler=sched)
        for i, pr in enumerate(PROMPTS):
            eng.submit(Request(uid=i, prompt=list(pr), max_new_tokens=2 + i))
        done[sched] = {r.uid: r.output for r in eng.run()}
        if sched == "wave":
            assert eng.stats["prefill_waves"] < len(PROMPTS)  # some wave held two
            assert eng.stats["prefill_tokens"] == sum(len(p) for p in PROMPTS)
    assert [done["wave"][i] for i in range(len(PROMPTS))] == expected
    assert done["wave"] == done["continuous"]


@pytest.mark.parametrize("backend", ["eager", "kernel"])
def test_wave_cache_matches_paged_pool(backend):
    """The dense per-wave cache and the paged pool hold the same K/V after
    a prefill and a decode step, and give the same logits."""
    ex = _executor(backend)
    tokens = np.array([PROMPTS[0], PROMPTS[1]])
    cache = ex.make_cache(2, 16)
    assert cache[0]["k"][0].shape == (2, 16, PLAN.pad_heads, PLAN.head_dim)
    lw, cache = ex.prefill(tokens, cache)
    pool = ex.make_pool(5, 8)
    rows = np.array([[1, 2], [3, 4]])
    lp = torch.cat([ex.prefill_paged(tokens[b:b + 1], pool, rows[b], length=11)[0]
                    for b in range(2)])
    torch.testing.assert_close(lw, lp, atol=1e-5, rtol=0)
    nxt = lw.argmax(-1)[:, None]
    dw, cache = ex.decode(nxt, cache, 11)
    dp, pool = ex.decode_paged(nxt, pool, rows, np.array([11, 11]))
    torch.testing.assert_close(dw, dp, atol=1e-5, rtol=0)
    for i in range(4):
        for b in range(2):
            paged = pool[0]["k"][i][rows[b]].reshape(16, PLAN.pad_heads, PLAN.head_dim)
            torch.testing.assert_close(cache[0]["k"][i][b, :12], paged[:12], atol=1e-6,
                                       rtol=0)


# --- the four schedules ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _layer_case(s: int):
    p = jhmp.init_layer_params(jax.random.PRNGKey(0), 32, 16, 64)
    x = np.random.default_rng(s).normal(size=(2, s, 32)).astype(np.float32) * 0.5
    ref = np.asarray(jax.jit(jhmp.reference_layer)(p, jnp.asarray(x)))
    (pt,), _ = hmp.params_from_numpy([p], np.zeros((1, 32)))
    return pt, torch.from_numpy(x), ref


@pytest.mark.parametrize("backend", ["eager", "kernel"])
@pytest.mark.parametrize("name", list(hmp.SCHEDULES))
@pytest.mark.parametrize("s", [16, 13])
def test_schedule_matches_reference_layer(s, name, backend):
    pt, x, ref = _layer_case(s)
    plan = PLAN.with_backend(backend)
    fn = hmp.SCHEDULES[name]
    if name.startswith("hmp"):
        lay = plan.seq_layout(s)
        y = lay.gather(fn(pt, lay.scatter(x), RING, plan=plan, seq=s))
    elif name == "megatron":
        y = fn(pt, x, RING, plan=plan)
    else:
        even = ExecPlan.even(4, num_heads=16, d_ff=64, head_dim=2,
                             d_model=32).with_backend(backend)
        if s % 4:
            with pytest.raises(ValueError, match="split evenly"):
                fn(pt, x, RING, plan=even)
            return
        y = fn(pt, x, RING, plan=even)
    np.testing.assert_allclose(y.numpy(), ref, atol=2e-5, rtol=0)


def test_baselines_without_a_plan_split_evenly():
    pt, x, ref = _layer_case(16)
    np.testing.assert_allclose(hmp.megatron_layer(pt, x, RING).numpy(), ref, atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(hmp.sp_layer(pt, x, RING).numpy(), ref, atol=2e-5, rtol=0)
    with pytest.raises(ValueError, match="ring has"):
        hmp.megatron_layer(pt, x, LocalRing(2), plan=PLAN)
    with pytest.raises(ValueError, match="do not split evenly"):
        ExecPlan.even(3, num_heads=16, d_ff=64, head_dim=2, d_model=32)


def test_one_device_ring_has_no_hops():
    """A one-device plan (the speculative draft's): the layer is the whole
    model on one shard, the ring runs one step and ships nothing."""
    pt, x, ref = _layer_case(16)
    one = ExecPlan.even(1, num_heads=16, d_ff=64, head_dim=2,
                        d_model=32).with_backend("kernel")
    ring = LocalRing(1)
    calls = []
    ring.permute = lambda vals, pairs: calls.append(pairs)
    for overlap in (False, True):
        y = hmp.hmp_layer(pt, x, ring, plan=one, overlap=overlap)
        np.testing.assert_allclose(y.numpy(), ref, atol=2e-5, rtol=0)
    assert calls == []
