"""The port's model zoo against the reference's, on RecurrentGemma reduced
to 5 layers (one ``rec,rec,attn`` group + the 2-block ``rec`` tail, d 256,
MQA 4:1 heads of 64, window 32): config, parameter tree, caches, the
``rglru_block`` and ``self_attention_block`` sub-layers, ``apply_model``
prefill then decode, and wave-served greedy tokens.

Both packages get the same weights, drawn with numpy from the reference's
``model_spec`` and its initializers (matrices at 4x the init scale, and
norm scales, gate weights and conv bias nonzero, so every term of the
blocks matters and greedy tokens vary), and carried over by
``params_from_numpy``.  Prompts (40 tokens) are longer than the window,
so the rolling cache wraps.

Tolerance: logits and block outputs agree within atol=rtol=1e-4 in fp32
— matmuls, the flash attention's softmax and the sequential scan (vs the
reference's associative scan) sum in another order.  Greedy tokens are
compared exactly.
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
from repro.models.attention import self_attention_block as _j_attn_block  # noqa: E402
from repro.models.params import PSpec as JPSpec  # noqa: E402
from repro.models.params import abstract_params as j_abstract_params  # noqa: E402
from repro.models.params import model_spec as j_model_spec  # noqa: E402
from repro.models.rglru import rglru_block as _j_rglru_block  # noqa: E402
from repro.models.transformer import apply_model as j_apply_model  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro.serving.kvcache import make_cache as j_make_cache  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import apply_model, init_params, params_from_numpy  # noqa: E402
from repro_torch.models.attention import self_attention_block  # noqa: E402
from repro_torch.models.params import group_params  # noqa: E402
from repro_torch.models.rglru import rglru_block  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine, TransformerExecutor  # noqa: E402
from repro_torch.serving.kvcache import make_cache  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
# the reference's blocks, compiled once per shape (op-by-op JAX is slower)
j_rglru_block = jax.jit(_j_rglru_block, static_argnums=2,
                        static_argnames=("mode", "deterministic"))
j_attn_block = jax.jit(_j_attn_block, static_argnums=2,
                       static_argnames=("mode", "window", "deterministic"))
ARCH = "recurrentgemma-9b"
B, S, MAX_LEN = 2, 40, 48


def _numpy_params(jcfg, seed=0):
    """The reference's parameter tree as numpy arrays, drawn from its
    ``model_spec`` with its initializers (see the module docstring)."""
    rng = np.random.default_rng(seed)

    def make(path, ps):
        grouped = getattr(path[0], "key", None) == "groups"
        shape = ((jcfg.num_groups,) if grouped else ()) + ps.shape
        if ps.init == "lru_a":
            u = rng.uniform(0.9, 0.999, shape)
            return np.log(np.expm1(-np.log(u) / 8.0)).astype(np.float32)
        if ps.init in ("zeros", "ones"):
            base = 1.0 if ps.init == "ones" else 0.0
            return (base + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = min(ps.scale, 1.0 / np.sqrt(fan_in))
        boost = 1.0 if path[-1].key == "tok" else 4.0
        return (rng.standard_normal(shape) * scale * boost).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        make, j_model_spec(jcfg), is_leaf=lambda x: isinstance(x, JPSpec))


@pytest.fixture(scope="module")
def zoo():
    jcfg = dataclasses.replace(j_reduced(j_get_config(ARCH)), num_layers=5)
    cfg = dataclasses.replace(reduced(get_config(ARCH)), num_layers=5)
    tree = _numpy_params(jcfg)
    rng = np.random.default_rng(1)
    return dict(jcfg=jcfg, cfg=cfg, jp=jax.tree.map(jnp.asarray, tree),
                p=params_from_numpy(tree),
                tokens=rng.integers(0, cfg.vocab_size, (B, S)),
                x=rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _close_tree(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        if isinstance(want[key], dict):
            _close_tree(got[key], want[key])
        else:
            _close(got[key], want[key])


# --- config, parameters, caches ------------------------------------------------

def test_config_matches_reference():
    full, jfull = get_config(ARCH), j_get_config(ARCH)
    for small, jsmall in ((full, jfull), (reduced(full), j_reduced(jfull))):
        for f in dataclasses.fields(small):
            assert getattr(small, f.name) == getattr(jsmall, f.name), f.name
        assert small.layer_kinds() == jsmall.layer_kinds()
        assert small.param_count() == jsmall.param_count()
        assert small.padded_vocab() == jsmall.padded_vocab()
    assert (full.num_groups, full.tail_pattern) == (12, ("rec", "rec"))
    assert abs(full.param_count() - 8.5e9) / 8.5e9 < 0.05


def test_init_params_tree_matches_reference(zoo):
    """The on-device init builds the reference's tree: same leaves, shapes
    and dtype; decays from ``lru_a`` land in [0.9, 0.999]."""
    cfg, jcfg = zoo["cfg"], zoo["jcfg"]
    p = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    want = jax.tree_util.tree_flatten_with_path(j_abstract_params(jcfg))[0]
    got = {jax.tree_util.keystr(k): v
           for k, v in jax.tree_util.tree_flatten_with_path(p)[0]}
    assert sorted(got) == sorted(jax.tree_util.keystr(k) for k, _ in want)
    for k, leaf in want:
        t = got[jax.tree_util.keystr(k)]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
    a = torch.exp(-8.0 * torch.nn.functional.softplus(p["groups"]["b0_rec"]["a_param"]))
    assert 0.9 - 1e-6 <= a.min() and a.max() <= 0.999 + 1e-6
    again = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    torch.testing.assert_close(again["embed"]["tok"], p["embed"]["tok"], rtol=0, atol=0)


def test_params_from_numpy_carries_bfloat16():
    tree = {"a": {"w": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3)},
            "b": np.ones(3, np.float32)}
    p = params_from_numpy(jax.tree.map(np.asarray, tree))
    assert p["a"]["w"].dtype == torch.bfloat16 and p["b"].dtype == torch.float32
    assert p["a"]["w"].float().tolist() == [[0, 1, 2], [3, 4, 5]]


def test_cache_shapes_match_reference(zoo):
    cfg, jcfg = zoo["cfg"], zoo["jcfg"]
    want = j_make_cache(jcfg, 3, 100, abstract=True)
    got = make_cache(cfg, 3, 100)
    for part in ("groups", "tail"):
        assert sorted(got[part]) == sorted(want[part])
        for key in want[part]:
            for n, leaf in want[part][key].items():
                t = got[part][key][n]
                assert tuple(t.shape) == leaf.shape, (part, key, n)
                assert str(t.dtype).split(".")[1] == str(leaf.dtype)
    # the sliding-window attention cache is W slots whatever the length
    assert got["groups"]["b2_attn"]["k"].shape[2] == cfg.window


# --- blocks -------------------------------------------------------------------

def _block_cache(rng, shapes):
    return {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}


@pytest.mark.parametrize("mode", ["train", "prefill", "prefill_h0", "decode"])
def test_rglru_block_matches_reference(zoo, mode):
    cfg, jcfg = zoo["cfg"], zoo["jcfg"]
    jp = jax.tree.map(lambda a: a[0], zoo["jp"]["groups"]["b0_rec"])
    p = group_params(zoo["p"], 0)["b0_rec"]
    rng = np.random.default_rng(2)
    x = zoo["x"][:, :1] if mode == "decode" else zoo["x"]
    cache = None
    if mode in ("prefill_h0", "decode"):
        w = cfg.lru_width
        cache = _block_cache(rng, {"h": (B, w), "conv": (B, cfg.conv_width - 1, w)})
    jmode = "prefill" if mode == "prefill_h0" else mode
    want, wcache = j_rglru_block(
        jp, jnp.asarray(x), jcfg, mode=jmode,
        cache=None if cache is None else jax.tree.map(jnp.asarray, cache),
        rng=None, deterministic=True)
    got, gcache = rglru_block(
        p, torch.from_numpy(x), cfg, mode=jmode,
        cache=None if cache is None else {n: torch.from_numpy(a) for n, a in cache.items()})
    _close(got, want)
    if mode == "train":
        assert gcache is None and wcache is None
    else:
        _close_tree(gcache, wcache)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode", "decode_per_slot"])
def test_self_attention_block_matches_reference(zoo, mode):
    """Sliding window 32 over 40 positions: prefill writes the last 32 keys
    at their slots mod 32; decode reads the wrapped rolling buffer."""
    cfg, jcfg = zoo["cfg"], zoo["jcfg"]
    jp = jax.tree.map(lambda a: a[0], zoo["jp"]["groups"]["b2_attn"])
    p = group_params(zoo["p"], 0)["b2_attn"]
    x = zoo["x"]
    pos = np.broadcast_to(np.arange(S), (B, S))
    kw = dict(window=cfg.window, rng=None, deterministic=True)
    jcache = j_make_cache(jcfg, B, MAX_LEN)["groups"]["b2_attn"]
    jcache = jax.tree.map(lambda a: a[0], jcache)
    cache = {n: torch.zeros(tuple(a.shape)) for n, a in jcache.items()}
    jmode = "train" if mode == "train" else "prefill"
    want, jcache = j_attn_block(jp, jnp.asarray(x), jcfg, mode=jmode,
                                cache=None if mode == "train" else jcache,
                                positions=jnp.asarray(pos), cache_index=None, **kw)
    got, cache = self_attention_block(p, torch.from_numpy(x), cfg, mode=jmode,
                                      window=cfg.window,
                                      cache=None if mode == "train" else cache,
                                      positions=torch.from_numpy(pos.copy()))
    if mode.startswith("decode"):
        xd = np.random.default_rng(3).standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        if mode == "decode":
            idx, jidx, dpos = S, jnp.int32(S), np.full((B, 1), S)
        else:
            depth = np.array([S, S - 9])
            idx, jidx, dpos = torch.from_numpy(depth), jnp.asarray(depth), depth[:, None]
        want, jcache = j_attn_block(jp, jnp.asarray(xd), jcfg, mode="decode",
                                    cache=jcache, positions=jnp.asarray(dpos),
                                    cache_index=jidx, **kw)
        got, cache = self_attention_block(p, torch.from_numpy(xd), cfg, mode="decode",
                                          window=cfg.window, cache=cache,
                                          positions=torch.from_numpy(dpos),
                                          cache_index=idx)
    _close(got, want)
    if mode != "train":
        _close_tree(cache, jcache)


def test_chunked_prefill_is_not_ported(zoo):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        apply_model(zoo["p"], zoo["cfg"], tokens=zoo["tokens"], mode="prefill",
                    cache=make_cache(zoo["cfg"], B, MAX_LEN), cache_index=4)


# --- the model ----------------------------------------------------------------

def test_apply_model_prefill_then_decode_matches_reference(zoo):
    """Logits of every prompt row, then of 4 lockstep decode steps and one
    per-slot step, fed the reference's greedy tokens; caches after."""
    cfg, jcfg, p, jp = zoo["cfg"], zoo["jcfg"], zoo["p"], zoo["jp"]
    prefill = jax.jit(lambda p, t, c: j_apply_model(
        p, jcfg, tokens=t, mode="prefill", cache=c)[:2])
    decode = jax.jit(lambda p, t, c, i: j_apply_model(
        p, jcfg, tokens=t, mode="decode", cache=c, cache_index=i)[:2])
    jl, jc = prefill(jp, jnp.asarray(zoo["tokens"]), j_make_cache(jcfg, B, MAX_LEN))
    got, cache = apply_model(p, cfg, tokens=zoo["tokens"], mode="prefill",
                             cache=make_cache(cfg, B, MAX_LEN))
    _close(got, jl)
    rows, _ = apply_model(p, cfg, tokens=zoo["tokens"], mode="prefill",
                          cache=make_cache(cfg, B, MAX_LEN), rows=S - 1)
    # the same rows, through a GEMM of another shape (another summation order)
    torch.testing.assert_close(rows, got[:, -1], rtol=0, atol=1e-6)
    tok = np.asarray(jl[:, -1].argmax(-1))[:, None]
    for step in range(5):
        if step < 4:
            jidx, idx = jnp.int32(S + step), S + step
        else:  # per-slot depths
            depth = np.array([S + step, S + step])
            jidx, idx = jnp.asarray(depth), torch.from_numpy(depth)
        jl, jc = decode(jp, jnp.asarray(tok), jc, jidx)
        got, cache = apply_model(p, cfg, tokens=tok, mode="decode", cache=cache,
                                 cache_index=idx)
        _close(got, jl)
        tok = np.asarray(jl[:, -1].argmax(-1))[:, None]
    _close_tree(cache, jc)


def test_wave_served_tokens_match_reference(zoo):
    """Two waves of two same-length prompts each, greedy: equal tokens and
    equal decode steps."""
    lens, max_new = [S, 12, S, 12], 6
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, zoo["cfg"].vocab_size, n).tolist() for n in lens]
    jeng = JEngine(zoo["jp"], zoo["jcfg"], max_batch=2, max_len=MAX_LEN)
    eng = ServingEngine(TransformerExecutor(zoo["p"], zoo["cfg"]), max_batch=2,
                        max_len=MAX_LEN, scheduler="wave")
    for i, pr in enumerate(prompts):
        jeng.submit(JRequest(uid=i, prompt=pr, max_new_tokens=max_new))
        eng.submit(Request(uid=i, prompt=pr, max_new_tokens=max_new))
    want = {r.uid: r.output for r in jeng.run()}
    got = {r.uid: r.output for r in eng.run()}
    assert got == want
    assert all(len(o) == max_new for o in got.values())
    assert len({t for o in got.values() for t in o}) > 4  # tokens vary
    assert eng.stats["decode_steps"] == jeng.stats["decode_steps"] == 2 * (max_new - 1)


def test_prefill_lengths_take_each_rows_last_real_token(zoo):
    """The wave protocol's ``lengths=`` branch (right-padded prompts) gives
    each row the logits of its last real token: a causal model's row
    depends on no later (pad) token."""
    ex = TransformerExecutor(zoo["p"], zoo["cfg"])
    tokens = zoo["tokens"]
    lengths = np.array([S, 23])
    both, _ = ex.prefill(tokens, ex.make_cache(B, MAX_LEN), lengths=lengths)
    for b, n in enumerate(lengths):
        alone, _ = ex.prefill(tokens[b:b + 1, :n], ex.make_cache(1, MAX_LEN))
        torch.testing.assert_close(both[b], alone[0], **TOL)


def test_scheduler_auto_takes_waves_for_the_zoo(zoo):
    ex = TransformerExecutor(zoo["p"], zoo["cfg"])
    assert not ex.supports_paged and ex.prompt_pad_multiple == 1
    with pytest.raises(ValueError, match="paged executor protocol"):
        ServingEngine(ex, scheduler="continuous")
    with pytest.raises(ValueError, match="unknown scheduler"):
        ServingEngine(ex, scheduler="fifo")
    with pytest.raises(ValueError, match="unknown compute backend"):
        TransformerExecutor(zoo["p"], zoo["cfg"], backend="pallas")
    eng = ServingEngine(ex, max_batch=2, max_len=12)
    eng.submit(Request(uid=0, prompt=[1] * 12, max_new_tokens=4))  # no room
    eng.submit(Request(uid=1, prompt=[2] * 5, max_new_tokens=0))
    eng.submit(Request(uid=2, prompt=[3] * 9, max_new_tokens=8))
    done = {r.uid: r for r in eng.run()}
    assert done[0].output == [] and done[1].output == [] and done[0].done
    assert len(done[2].output) == 3  # max_len 12 - 9 prompt tokens


def test_serve_cli_zoo_on_cpu():
    """``launch.serve --executor zoo --reduce --device cpu``: two waves
    (three 9-token prompts, max batch 2), every request at its count."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        launch_serve.main(["--executor", "zoo", "--model", ARCH, "--reduce",
                           "--device", "cpu", "--prompt-lens", "9,9,9", "--max-new", "3",
                           "--max-batch", "2"])
    lines = buf.getvalue().strip().splitlines()
    assert lines[0].startswith("recurrentgemma-9b-smoke: 3 layers")
    stats = json.loads(lines[-1])
    assert stats["new_tokens"] == 9
    assert stats["stats"]["decode_steps"] == 4
    with pytest.raises(ValueError, match="galaxy executor serves"):
        launch_serve.serve(ARCH, device="cpu")
    with pytest.raises(ValueError, match="zoo executor serves"):
        launch_serve.serve("gpt2-l", executor_kind="zoo", device="cpu")
