"""The port's MoE family against the reference's: the configs of
olmoe-1b-7b and granite-moe-3b-a800m (full and reduced, parameter counts),
the parameter tree's shapes (granite's 40 experts padded to 48),
``moe_apply`` and its three aux values over token-group sizes, a capacity
overflow, padded experts and tied router logits, ``apply_model`` prefill
then decode, and the greedy tokens the engine serves under the continuous
scheduler with the prefix cache and chunks (decode steps with dead slots
among them), then the zoo serve CLI on the CPU.

Inputs are drawn with numpy and passed through both packages in fp32,
the reference's zero-init leaves (norm scales) set to seeded random
values.  Tolerance: ``moe_apply`` within atol=rtol=1e-5 (the same
routing, GEMMs summed in another order), logits within 1e-4 (two
layers); tokens exactly.
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
from repro.models.moe import _group_size as j_group_size  # noqa: E402
from repro.models.moe import moe_apply as j_moe_apply  # noqa: E402
from repro.models.params import PSpec as JPSpec  # noqa: E402
from repro.models.params import model_spec as j_model_spec  # noqa: E402
from repro.models.transformer import apply_model as j_apply_model  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro.serving.engine import TransformerExecutor as JExecutor  # noqa: E402
from repro.serving.kvcache import cache_bytes as j_cache_bytes  # noqa: E402
from repro.serving.kvcache import make_cache as j_make_cache  # noqa: E402
from repro_torch.configs import ZOO_MODELS, get_config, reduced  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import apply_model, model_spec, params_from_numpy  # noqa: E402
from repro_torch.models.moe import _group_size, moe_apply, moe_capacity, moe_route  # noqa: E402
from repro_torch.models.params import param_bytes  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine, TransformerExecutor  # noqa: E402
from repro_torch.serving.kvcache import cache_bytes, make_cache  # noqa: E402

MOE = ("olmoe-1b-7b", "granite-moe-3b-a800m")
TOL5 = dict(atol=1e-5, rtol=1e-5)
TOL4 = dict(atol=1e-4, rtol=1e-4)


def numpy_params(jcfg, seed=0):
    """The reference's parameter tree drawn with numpy: matrices at 4x the
    init scale, zero- and one-init leaves (norm scales, biases, gates) at
    seeded random values around their init, so no path is constant."""
    rng = np.random.default_rng(seed)

    def make(path, ps):
        grouped = getattr(path[0], "key", None) == "groups"
        shape = ((jcfg.num_groups,) if grouped else ()) + ps.shape
        if ps.init in ("zeros", "ones"):
            base = 1.0 if ps.init == "ones" else 0.0
            return (base + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = min(ps.scale, 1.0 / np.sqrt(fan_in))
        boost = 1.0 if path[-1].key == "tok" else 4.0
        return (rng.standard_normal(shape) * scale * boost).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        make, j_model_spec(jcfg), is_leaf=lambda x: isinstance(x, JPSpec))


def spec_shapes(tree, is_leaf, shape_of):
    """{path: shape} of a nested dict of specs."""
    out = {}
    for key, val in tree.items():
        if is_leaf(val):
            out[(key,)] = tuple(shape_of(val))
        else:
            out.update({(key,) + p: s for p, s in spec_shapes(val, is_leaf, shape_of).items()})
    return out


def check_config_and_tree(arch):
    """The port's config (full and reduced) equals the reference's field by
    field, with equal parameter counts (all and active only), equal cache
    bytes, and a parameter tree of the same shapes and initializers."""
    full, jfull = get_config(arch), j_get_config(arch)
    assert ZOO_MODELS[arch] is full
    for small, jsmall in ((full, jfull), (reduced(full), j_reduced(jfull))):
        for f in dataclasses.fields(small):
            assert getattr(small, f.name) == getattr(jsmall, f.name), f.name
        for active in (False, True):
            assert small.param_count(active_only=active) == jsmall.param_count(active_only=active)
        assert cache_bytes(small, 3, 40) == j_cache_bytes(jsmall, 3, 40)
        for kind in ("attn", "mlstm", "slstm"):
            assert small.count_kind(kind) == jsmall.count_kind(kind)
        got = spec_shapes(model_spec(small), lambda v: not isinstance(v, dict),
                          lambda ps: ps.shape + (ps.init, ps.scale))
        want = spec_shapes(j_model_spec(jsmall), lambda v: isinstance(v, JPSpec),
                           lambda ps: ps.shape + (ps.init, ps.scale))
        assert got == want
    return full


@pytest.mark.parametrize("arch", MOE)
def test_moe_config_and_tree_match_reference(arch):
    full = check_config_and_tree(arch)
    assert full.is_moe and full.family == "moe" and full.dtype == "bfloat16"
    moe = model_spec(full)["groups"]["b0_attn"]["moe"]
    experts = {"olmoe-1b-7b": 64, "granite-moe-3b-a800m": 48}[arch]
    assert moe["we_up"].shape[0] == moe["router"].shape[1] == experts
    assert "mlp" not in model_spec(full)["groups"]["b0_attn"]
    gb = {"olmoe-1b-7b": 13.84, "granite-moe-3b-a800m": 7.81}[arch]
    assert abs(param_bytes(full) / 1e9 - gb) < 0.01


def test_group_size_and_capacity():
    for total, t in ((256, 128), (293, 1), (37, 37), (300, 100), (4, 4), (1, 1)):
        assert _group_size(total) == j_group_size(total) == t
    cfg = get_config("olmoe-1b-7b")
    assert moe_capacity(cfg, 4) == 1 and moe_capacity(cfg, 128) == 32
    assert moe_capacity(cfg, 1) == 1 and moe_capacity(cfg, 128, 0.5) == 8


# --- moe_apply ------------------------------------------------------------------

def _moe_case(arch, d, ff, experts=None, k=None):
    """A small MoE config of ``arch`` on both sides (experts >= 16 pad)."""
    rep = dict(d_model=d, d_ff=ff)
    if experts is not None:
        rep.update(num_experts=experts, experts_per_token=k)
    return (dataclasses.replace(j_reduced(j_get_config(arch)), **rep),
            dataclasses.replace(reduced(get_config(arch)), **rep))


def _moe_params(jcfg, rng, tie=False):
    spec = j_model_spec(jcfg)["groups"]["b0_attn"]["moe"]
    p = {n: (rng.standard_normal(ps.shape) / np.sqrt(ps.shape[-2])).astype(np.float32)
         for n, ps in spec.items()}
    if tie:  # pairs of equal router columns: equal logits, bit for bit
        p["router"][:, 1::2] = p["router"][:, 0::2]
    return p


MOE_CASES = {
    # (arch, batch, seq, capacity factor, experts, k, tied router); at the
    # reduced 4 experts top 2 the default factor 2.0 never fills an expert,
    # so the group-size cases take 1.0 and the group decides what drops
    "groups-of-128": ("olmoe-1b-7b", 2, 128, 1.0, None, None, False),
    "prime-293": ("olmoe-1b-7b", 1, 293, 0.0, None, None, False),
    "prime-37": ("granite-moe-3b-a800m", 1, 37, 1.0, None, None, False),
    "groups-of-100": ("granite-moe-3b-a800m", 2, 150, 1.0, None, None, False),
    "overflow": ("olmoe-1b-7b", 2, 64, 0.5, None, None, False),
    "padded-40-of-48": ("granite-moe-3b-a800m", 1, 96, 0.0, 40, 8, False),
    "tied-logits": ("olmoe-1b-7b", 1, 64, 0.0, 16, 4, True),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_reference(case):
    arch, b, s, cf, experts, k, tie = MOE_CASES[case]
    jcfg, cfg = _moe_case(arch, 64, 32, experts, k)
    rng = np.random.default_rng(len(case))
    p = _moe_params(jcfg, rng, tie)
    x = rng.standard_normal((b, s, 64)).astype(np.float32)
    want, jaux = jax.jit(lambda p, x: j_moe_apply(p, x, jcfg, capacity_factor=cf))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = params_from_numpy(p)
    got, aux = moe_apply(tp, torch.from_numpy(x), cfg, capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL5)
    for name, val in jaux.items():
        np.testing.assert_allclose(aux[name].item(), float(val), **TOL5)
    t = _group_size(b * s)
    logits, _, idx = moe_route(tp, torch.from_numpy(x).reshape(-1, t, 64), cfg)
    e_pad = p["router"].shape[1]
    assert logits.shape[-1] == e_pad and bool((idx < cfg.num_experts).all())
    if cf:
        assert aux["moe_drop_frac"].item() > {0.5: 0.05, 1.0: 0.0}[cf]
    if tie:  # the tied logits, ranked as jax.lax.top_k ranks them
        _, jidx = jax.lax.top_k(jnp.asarray(logits.numpy()), cfg.experts_per_token)
        assert np.array_equal(idx.numpy(), np.asarray(jidx))
        assert bool((logits[..., 0::2] == logits[..., 1::2]).all())
    if experts == 40:
        assert e_pad == 48 and bool((logits[..., 40:] == -1e30).all())


# --- apply_model and the engine ----------------------------------------------------

@pytest.fixture(scope="module", params=MOE)
def zoo(request):
    """The reduced model on both sides at capacity factor 0.5: 4 experts
    top 2 at the default 2.0 never fill (capacity >= group size), so every
    row of a call competes for capacity only below it, as at full width,
    where a 4-slot decode step has capacity 1."""
    jcfg, cfg = (dataclasses.replace(c, moe_capacity_factor=0.5) for c in (
        j_reduced(j_get_config(request.param)), reduced(get_config(request.param))))
    tree = numpy_params(jcfg)
    return dict(arch=request.param, jcfg=jcfg, cfg=cfg, tree=tree,
                jparams=jax.tree.map(jnp.asarray, tree), params=params_from_numpy(tree))


def test_apply_model_prefill_then_decode_matches_reference(zoo):
    """Prefill of 2 x 37 tokens (one group of 74 rows), then two decode
    steps: logits of every row and the MoE aux values."""
    jcfg, cfg = zoo["jcfg"], zoo["cfg"]
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 37))
    jpre = jax.jit(lambda p, t, c: j_apply_model(p, jcfg, tokens=t, mode="prefill", cache=c))
    jdec = jax.jit(lambda p, t, c, i: j_apply_model(p, jcfg, tokens=t, mode="decode",
                                                   cache=c, cache_index=i))
    want, jcache, jaux = jpre(zoo["jparams"], jnp.asarray(tokens, jnp.int32),
                              j_make_cache(jcfg, 2, 48))
    aux = {}
    got, cache = apply_model(zoo["params"], cfg, tokens=tokens, mode="prefill",
                             cache=make_cache(cfg, 2, 48), aux=aux)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL4)
    for name, val in jaux.items():
        np.testing.assert_allclose(aux[name].item(), float(val), **TOL4)
    assert aux["moe_drop_frac"].item() > 0
    tok = np.asarray(want[:, -1].argmax(-1))[:, None]
    for step in range(2):
        want, jcache, jaux = jdec(zoo["jparams"], jnp.asarray(tok, jnp.int32), jcache,
                                  jnp.int32(37 + step))
        got, cache = apply_model(zoo["params"], cfg, tokens=tok, mode="decode", cache=cache,
                                 cache_index=37 + step, aux=aux)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL4)
        np.testing.assert_allclose(aux["moe_drop_frac"].item(),
                                   float(jaux["moe_drop_frac"]), **TOL4)
        tok = np.asarray(want[:, -1].argmax(-1))[:, None]


_SYS = [7, 7, 7] + list(range(50, 79))  # 32 tokens: 4 pages at page_size 8


def test_served_tokens_equal_reference_engine(zoo):
    """Continuous scheduler, prefix cache and 8-token chunks on 3 slots:
    6 requests of the shared 32-token prompt plus 5-10 own tokens, 3 or 9
    new tokens each, so slots die and sit mid-prefill while others decode
    (their rows, token 0 at position 0, join the MoE's token group).
    Greedy tokens equal the reference engine's, with equal stats."""
    rng = np.random.default_rng(0)
    prompts = [(_SYS + [int(t) for t in rng.integers(1, 300, 5 + i)], 3 if i % 2 else 9)
               for i in range(6)]
    kw = dict(max_batch=3, max_len=64, page_size=8, scheduler="continuous",
              prefix_cache=True, prefill_chunk=8)
    engines = (JEngine(executor=JExecutor(zoo["jparams"], zoo["jcfg"]), **kw),
               ServingEngine(TransformerExecutor(zoo["params"], zoo["cfg"]), **kw))
    outs = []
    for eng, req in zip(engines, (JRequest, Request)):
        for i, (prompt, n) in enumerate(prompts):
            eng.submit(req(uid=i, prompt=list(prompt), max_new_tokens=n))
        outs.append({r.uid: r.output for r in eng.run()})
    assert outs[0] == outs[1]
    jst, st = dict(engines[0].stats), dict(engines[1].stats)
    for key in ("decode_steps", "decode_tokens", "prefill_chunks", "prefix_hits",
                "cached_prefix_tokens", "prefill_tokens"):
        assert st[key] == jst[key], key
    assert st["decode_tokens"] < 3 * st["decode_steps"]  # steps with dead slots
    assert st["prefix_hits"] >= 1 and st["prefill_chunks"] > 0


@pytest.mark.parametrize("arch", MOE)
def test_serve_cli_moe_on_cpu(arch):
    """``launch.serve --executor zoo --model <moe> --reduce`` pages the
    model with the prefix cache and chunks on the CPU."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        launch_serve.main(["--executor", "zoo", "--model", arch, "--reduce",
                           "--device", "cpu", "--requests", "4", "--prompt-len", "9-20",
                           "--shared-prefix", "32", "--prefix-cache", "on",
                           "--prefill-chunk", "16", "--max-new", "3", "--max-batch", "2"])
    lines = buf.getvalue().strip().splitlines()
    assert lines[0].startswith(f"{arch}-smoke: 2 layers")
    assert "x 4 experts (top 2)" in lines[0] and lines[0].endswith("continuous scheduler")
    out = json.loads(lines[-1])
    assert out["new_tokens"] == 12
    assert out["stats"]["prefix_hits"] >= 1 and out["stats"]["prefill_chunks"] > 0
