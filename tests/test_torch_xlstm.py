"""The port's xLSTM family against the reference's: xlstm-350m's config
(full and reduced) and parameter tree, the fresh recurrent caches
(``m = -1e30``, sLSTM ``n = 1e-6``, fp32), ``mlstm_block`` in prefill
(the recurrent step path at a length that is not a multiple of the chunk,
the chunkwise-parallel path at S 256) and decode, the step scan against
the chunked form, ``slstm_block`` in prefill and decode, ``apply_model``
prefill then decode, and the greedy tokens the engine serves in waves
(one wave of a multiple of 128 tokens, one not), then the zoo serve CLI
on the CPU.

Inputs are drawn with numpy and passed through both packages in fp32;
the reference's zero-init leaves (gates ``w_if``/``b_if``, ``b_in``, the
norm scales) are set to seeded random values, or the gate paths would be
constant.  Tolerance, relative to the largest magnitude of the
reference's output: blocks and states within 1e-5, logits within 1e-4
(the reference's own jit and eager mLSTM prefill differ by 2.0e-5 at a
largest output of 8.5, 2.4e-6 of it); tokens exactly.
"""
import dataclasses
import io
import json
from contextlib import redirect_stdout

import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread, so the xdist workers beside it keep their cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro.models.transformer import apply_model as j_apply_model  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro.serving.engine import TransformerExecutor as JExecutor  # noqa: E402
from repro.serving.kvcache import make_cache as j_make_cache  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import apply_model, params_from_numpy  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine, TransformerExecutor  # noqa: E402
from repro_torch.serving.kvcache import make_cache  # noqa: E402
from test_torch_moe import check_config_and_tree, numpy_params  # noqa: E402

ARCH = "xlstm-350m"
TOL5, TOL4 = 1e-5, 1e-4


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = j_reduced(j_get_config(ARCH)), reduced(get_config(ARCH))
    tree = numpy_params(jcfg)
    return dict(jcfg=jcfg, cfg=cfg, tree=tree, jparams=jax.tree.map(jnp.asarray, tree),
                params=params_from_numpy(tree))


def _close(got, want, tol=TOL5):
    """Within ``tol`` of the reference, relative to its largest magnitude."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * np.abs(want).max())


def _close_tree(got, want, tol=TOL5):
    assert set(got) == set(want)
    for name in got:
        _close(got[name], want[name], tol)


def test_xlstm_config_and_tree_match_reference():
    full = check_config_and_tree(ARCH)
    assert full.block_pattern == ("mlstm", "slstm") and full.d_ff == 0
    assert full.count_kind("mlstm") == full.count_kind("slstm") == 12
    assert not TransformerExecutor(
        {"embed": {"tok": torch.zeros(1)}}, reduced(full)).supports_paged


def test_fresh_caches_match_reference(model):
    jcfg, cfg = model["jcfg"], model["cfg"]
    got, want = make_cache(cfg, 2, 16), j_make_cache(jcfg, 2, 16)
    for part in ("groups", "tail"):
        for key, leaves in want[part].items():
            for name, leaf in leaves.items():
                t = got[part][key][name]
                assert t.dtype == torch.float32 and tuple(t.shape) == leaf.shape
                assert np.array_equal(t.numpy(), np.asarray(leaf)), (key, name)
    assert bool((got["groups"]["b0_mlstm"]["m"] == -1e30).all())
    assert bool((got["groups"]["b1_slstm"]["n"] == 1e-6).all())


def _block_inputs(model, kind, b, s, seed):
    p = {k: v for k, v in model["tree"]["groups"][f"b{int(kind == 'slstm')}_{kind}"].items()}
    p = jax.tree.map(lambda a: a[0], p)  # group 0
    x = np.random.default_rng(seed).standard_normal((b, s, model["cfg"].d_model))
    return p, x.astype(np.float32)


def _ref_block(kind, jcfg, mode):
    fn = jx.mlstm_block if kind == "mlstm" else jx.slstm_block
    return jax.jit(lambda p, x, c: fn(p, x, jcfg, mode=mode, cache=c, rng=None,
                                      deterministic=True))


@pytest.mark.parametrize("kind,s", [("mlstm", 37), ("mlstm", 256), ("slstm", 37)])
def test_block_prefill_then_decode_matches_reference(model, kind, s):
    """Prefill (mLSTM: the step path at 37, the chunked path at 256) from a
    fresh state, then two decode steps: outputs and states."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    p, x = _block_inputs(model, kind, 2, s + 2, seed=s)
    tp = params_from_numpy(p)
    fn = xlstm.mlstm_block if kind == "mlstm" else xlstm.slstm_block
    init = (jx.init_mlstm_cache if kind == "mlstm" else jx.init_slstm_cache)(jcfg, 2)
    xlstm.reset_mlstm_paths()
    want, jc = _ref_block(kind, jcfg, "prefill")(p, x[:, :s], init)
    got, c = fn(tp, torch.from_numpy(x[:, :s]), cfg, mode="prefill", cache=None)
    _close(got, want)
    _close_tree(c, jc)
    if kind == "mlstm":
        path = "chunked" if s == 256 else "step"
        assert xlstm.MLSTM_PATHS == {"chunked": int(path == "chunked"), "step": int(path == "step")}
    for t in (s, s + 1):
        want, jc = _ref_block(kind, jcfg, "decode")(p, x[:, t:t + 1], jc)
        got, c = fn(tp, torch.from_numpy(x[:, t:t + 1]), cfg, mode="decode", cache=c)
        _close(got, want)
        _close_tree(c, jc)


def test_mlstm_chunked_equals_step_scan(model):
    """At S 256 the chunked form and the step scan agree with each other
    (port) and with the reference's two forms, from a nonzero state."""
    cfg = model["cfg"]
    rng = np.random.default_rng(5)
    b, s, nh, dh = 2, 256, cfg.num_heads, 2 * cfg.d_model // cfg.num_heads
    q, k, v = (rng.standard_normal((b, s, nh, dh)).astype(np.float32) for _ in range(3))
    k /= np.sqrt(dh)
    i_raw, f_raw = (rng.standard_normal((b, s, nh)).astype(np.float32) + off
                    for off in (0.0, 2.0))
    st = (0.1 * rng.standard_normal((b, nh, dh, dh)).astype(np.float32),
          0.1 * rng.standard_normal((b, nh, dh)).astype(np.float32),
          rng.standard_normal((b, nh)).astype(np.float32))
    args = (q, k, v, i_raw, f_raw)
    targs = [torch.from_numpy(a) for a in args]
    tst = tuple(torch.from_numpy(a) for a in st)
    h_scan, st_scan = xlstm.mlstm_scan(*targs, tst)
    h_chunk, st_chunk = xlstm.mlstm_chunked(*targs, tst, 128)
    jh_scan, jst_scan = jax.jit(jx.mlstm_scan)(*args, st)
    jh_chunk, jst_chunk = jax.jit(jx.mlstm_chunked, static_argnums=6)(*args, st, 128)
    _close(h_chunk, h_scan)
    for got, want in ((h_scan, jh_scan), (h_chunk, jh_chunk)):
        _close(got, want)
    for got, want in zip(st_scan + st_chunk, jst_scan + jst_chunk):
        _close(got, want)
    for a, b_ in zip(st_chunk, st_scan):
        _close(a, b_)


@pytest.mark.parametrize("s", [37, 256])
def test_apply_model_prefill_then_decode_matches_reference(model, s):
    """The reduced model (one mLSTM and one sLSTM layer): train logits,
    prefill logits of every row, then two decode steps."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    tokens = np.random.default_rng(s).integers(0, cfg.vocab_size, (2, s))
    jtok = jnp.asarray(tokens, jnp.int32)
    want, _, _ = jax.jit(lambda p, t: j_apply_model(p, jcfg, tokens=t))(model["jparams"], jtok)
    got, _ = apply_model(model["params"], cfg, tokens=tokens)
    _close(got, want, TOL4)
    want, jcache, _ = jax.jit(lambda p, t, c: j_apply_model(
        p, jcfg, tokens=t, mode="prefill", cache=c))(model["jparams"], jtok,
                                                       j_make_cache(jcfg, 2, s + 2))
    got, cache = apply_model(model["params"], cfg, tokens=tokens, mode="prefill",
                             cache=make_cache(cfg, 2, s + 2))
    _close(got, want, TOL4)
    jdec = jax.jit(lambda p, t, c, i: j_apply_model(p, jcfg, tokens=t, mode="decode",
                                                   cache=c, cache_index=i))
    tok = np.asarray(want[:, -1].argmax(-1))[:, None]
    for step in range(2):
        want, jcache, _ = jdec(model["jparams"], jnp.asarray(tok, jnp.int32), jcache,
                               jnp.int32(s + step))
        got, cache = apply_model(model["params"], cfg, tokens=tok, mode="decode",
                                 cache=cache, cache_index=s + step)
        _close(got, want, TOL4)
        tok = np.asarray(want[:, -1].argmax(-1))[:, None]


def test_served_tokens_equal_reference_engine_in_waves(model):
    """``auto`` serves xLSTM in waves: 2 prompts of 256 tokens (the chunked
    mLSTM path) and 3 of 37 (the step path), 4 new tokens each, 2 slots:
    greedy tokens equal the reference engine's."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, model["cfg"].vocab_size, n).tolist()
               for n in (256, 37, 256, 37, 37)]
    kw = dict(max_batch=2, max_len=264, scheduler="auto")
    engines = (JEngine(executor=JExecutor(model["jparams"], model["jcfg"]), **kw),
               ServingEngine(TransformerExecutor(model["params"], model["cfg"]), **kw))
    outs = []
    xlstm.reset_mlstm_paths()
    for eng, req in zip(engines, (JRequest, Request)):
        for i, prompt in enumerate(prompts):
            eng.submit(req(uid=i, prompt=list(prompt), max_new_tokens=4))
        outs.append({r.uid: r.output for r in eng.run()})
    assert outs[0] == outs[1]
    assert engines[1].stats["prefill_waves"] == 3
    assert xlstm.MLSTM_PATHS == {"chunked": 1, "step": 2}


def test_serve_cli_xlstm_on_cpu():
    """``launch.serve --executor zoo --model xlstm-350m --reduce`` serves in
    waves on the CPU."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        launch_serve.main(["--executor", "zoo", "--model", ARCH, "--reduce", "--device",
                           "cpu", "--prompt-lens", "12,12,9", "--max-new", "3"])
    lines = buf.getvalue().strip().splitlines()
    assert lines[0].startswith(f"{ARCH}-smoke: 2 layers (1 x [mlstm,slstm] + 0 tail)")
    assert lines[0].endswith("wave scheduler")
    out = json.loads(lines[-1])
    assert out["new_tokens"] == 9 and out["stats"]["prefill_waves"] == 2


def test_chunked_prefill_refused_for_recurrent_stacks(model):
    cfg = model["cfg"]
    with pytest.raises(ValueError, match="full-causal"):
        apply_model(model["params"], cfg, tokens=np.zeros((1, 8), np.int64), mode="prefill",
                    cache=make_cache(cfg, 1, 16), cache_index=8)
    # dropout is ported: a config with a rate runs, and without a step's
    # generator (deterministic, the default) gives the logits of rate 0
    tokens = np.zeros((1, 8), np.int64)
    with_rate, _ = apply_model(model["params"], dataclasses.replace(cfg, dropout_rate=0.1),
                               tokens=tokens)
    assert torch.equal(with_rate, apply_model(model["params"], cfg, tokens=tokens)[0])
