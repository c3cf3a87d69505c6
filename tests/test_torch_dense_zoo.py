"""The port's dense GQA zoo against the reference's: configs, the paged
cache helpers, chunked prefill at an offset, and ``TransformerExecutor``'s
paged protocol (``prefill_paged``, ``prefill_chunk`` at two offsets,
``decode_paged``) on reduced qwen1.5-0.5b (MHA, QKV bias, tied
embeddings, RMSNorm) and reduced stablelm-12b (LayerNorm, untied; set to
4 query heads on 2 KV heads on both sides, since ``reduced`` gives it 4 on
4), then the zoo serve CLI with the prefix cache and chunks on the CPU.

Both packages get the same weights, drawn with numpy from the reference's
``model_spec`` (matrices at 4x the init scale, norm scales and biases
nonzero).  Tolerance: logits and pool pages within atol=rtol=1e-4 in
fp32 (GEMMs and the attention's softmax sum in another order).
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
from repro.models.params import PSpec as JPSpec  # noqa: E402
from repro.models.params import model_spec as j_model_spec  # noqa: E402
from repro.serving.engine import TransformerExecutor as JExecutor  # noqa: E402
from repro.serving.kvcache import cache_bytes as j_cache_bytes  # noqa: E402
from repro.serving.kvcache import cache_page_size as j_cache_page_size  # noqa: E402
from repro_torch.configs import ZOO_MODELS, get_config, reduced  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import apply_model, params_from_numpy  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine, TransformerExecutor  # noqa: E402
from repro_torch.serving.kvcache import (  # noqa: E402
    cache_bytes,
    cache_page_size,
    make_cache,
    map_cache_leaves,
)

TOL = dict(atol=1e-4, rtol=1e-4)
DENSE = ("qwen1.5-0.5b", "codeqwen1.5-7b", "stablelm-12b", "qwen1.5-110b")
PAGE, WIDTH = 8, 4  # 4 pages of 8 positions per slot


def _configs(arch):
    jcfg, cfg = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    if arch == "stablelm-12b":  # keep GQA under test
        jcfg = dataclasses.replace(jcfg, num_kv_heads=2)
        cfg = dataclasses.replace(cfg, num_kv_heads=2)
    return jcfg, cfg


def _numpy_params(jcfg, seed=0):
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


@pytest.fixture(scope="module", params=["qwen1.5-0.5b", "stablelm-12b"])
def zoo(request):
    jcfg, cfg = _configs(request.param)
    tree = _numpy_params(jcfg)
    return dict(arch=request.param, jcfg=jcfg, cfg=cfg,
                jex=JExecutor(jax.tree.map(jnp.asarray, tree), jcfg),
                ex=TransformerExecutor(params_from_numpy(tree), cfg),
                tokens=np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24)))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


# --- configs and cache helpers -------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_matches_reference(arch):
    full, jfull = get_config(arch), j_get_config(arch)
    assert ZOO_MODELS[arch] is full
    for small, jsmall in ((full, jfull), (reduced(full), j_reduced(jfull))):
        for f in dataclasses.fields(small):
            assert getattr(small, f.name) == getattr(jsmall, f.name), f.name
        assert small.param_count() == jsmall.param_count()
        assert cache_bytes(small, 3, 50) == j_cache_bytes(jsmall, 3, 50)
    assert TransformerExecutor.supports_paged.fget(
        dataclasses.make_dataclass("E", [("cfg", object)])(full))


def test_stablelm_is_gqa_at_head_dim_160():
    cfg = get_config("stablelm-12b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff) == (40, 5120, 32, 8, 160, 13824)
    assert cache_bytes(cfg, 1, 1) == 200 * 1024  # KV bytes per token
    assert abs(cfg.param_count() - 12.14e9) / 12.14e9 < 0.01


def test_paged_cache_helpers_match_reference(zoo):
    jcfg, cfg = zoo["jcfg"], zoo["cfg"]
    pool, jpool = make_cache(cfg, 5, PAGE), zoo["jex"].make_pool(5, PAGE)
    assert cache_page_size(pool) == j_cache_page_size(jpool) == PAGE
    seen = []
    out = map_cache_leaves(pool, pool, lambda a, b, grouped: seen.append(grouped) or a.shape)
    assert out["groups"]["b0_attn"]["k"] == (jcfg.num_groups, 5, PAGE, cfg.num_kv_heads,
                                             cfg.head_dim)
    assert seen == [True, True]


# --- chunked prefill at an offset ----------------------------------------------

def test_chunked_prefill_needs_full_causal_attention(zoo):
    cfg = dataclasses.replace(zoo["cfg"], window=8)
    with pytest.raises(ValueError, match="full-causal"):
        apply_model(zoo["ex"].params, cfg, tokens=zoo["tokens"][:1, :8], mode="prefill",
                    cache=make_cache(cfg, 1, 32), cache_index=8)
    ex = TransformerExecutor(zoo["ex"].params, cfg)
    assert not ex.supports_paged and zoo["ex"].supports_paged


def test_chunked_prefill_equals_one_shot(zoo):
    """apply_model in two chunks of 12 at offsets 0 and 12 gives the
    one-shot prefill's logits of every row and its cache."""
    p, cfg, tokens = zoo["ex"].params, zoo["cfg"], zoo["tokens"][:1]
    whole, wcache = apply_model(p, cfg, tokens=tokens, mode="prefill",
                                cache=make_cache(cfg, 1, 32))
    cache = make_cache(cfg, 1, 32)
    parts = []
    for off in (0, 12):
        lg, cache = apply_model(p, cfg, tokens=tokens[:, off:off + 12], mode="prefill",
                                cache=cache, cache_index=off)
        parts.append(lg)
    torch.testing.assert_close(torch.cat(parts, 1), whole, **TOL)
    for n in ("k", "v"):
        torch.testing.assert_close(cache["groups"]["b0_attn"][n],
                                   wcache["groups"]["b0_attn"][n], **TOL)


# --- the paged protocol ----------------------------------------------------------

def test_paged_protocol_matches_reference(zoo):
    """Slot 0: one-shot ``prefill_paged`` of 21 tokens (padded to 24);
    slot 1: ``prefill_chunk`` of 24 tokens at offsets 0, 8 and 16; then 3
    ``decode_paged`` steps of both slots, with the reference's greedy
    tokens fed to both; the pools' pages after."""
    ex, jex, tokens = zoo["ex"], zoo["jex"], zoo["tokens"]
    rows = np.arange(1, 1 + 2 * WIDTH, dtype=np.int32).reshape(2, WIDTH)
    pool, jpool = ex.make_pool(1 + 2 * WIDTH, PAGE), jex.make_pool(1 + 2 * WIDTH, PAGE)

    got, pool = ex.prefill_paged(tokens[:1], pool, rows[0], length=21)
    want, jpool = jex.prefill_paged(jnp.asarray(tokens[:1], jnp.int32), jpool,
                                    jnp.asarray(rows[0]), length=21)
    _close(got, want)
    first = [int(np.argmax(want[0]))]
    for off in (0, 8, 16):
        chunk = tokens[1:, off:off + 8]
        got, pool = ex.prefill_chunk(chunk, pool, rows[1], offset=off, length=24)
        want, jpool = jex.prefill_chunk(jnp.asarray(chunk, jnp.int32), jpool,
                                        jnp.asarray(rows[1]), offset=off, length=24)
        assert tuple(got.shape) == tuple(want.shape) == (1, 8, ex.params["head"]["w"].shape[-1]
                                                         if "head" in ex.params
                                                         else ex.params["embed"]["tok"].shape[0])
        _close(got, want)
    first.append(int(np.argmax(want[0, -1])))
    tok = np.array(first, np.int32)[:, None]
    positions = np.array([21, 24], np.int32)
    for step in range(3):
        got, pool = ex.decode_paged(tok, pool, rows, positions + step)
        want, jpool = jex.decode_paged(jnp.asarray(tok), jpool, jnp.asarray(rows),
                                       jnp.asarray(positions + step))
        _close(got, want)
        tok = np.asarray(want.argmax(-1), np.int32)[:, None]
    for n in ("k", "v"):
        _close(pool["groups"]["b0_attn"][n][:, 1:], jpool["groups"]["b0_attn"][n][:, 1:])


def test_idle_rows_decode_against_the_null_page(zoo):
    """A row of null pages at position 0 (an idle slot) writes only page 0:
    the live slot's pages and logits are those of decoding it alone."""
    ex, tokens = zoo["ex"], zoo["tokens"]
    row = np.arange(1, 1 + WIDTH)
    pools = []
    for bt in (row[None], np.stack([row, np.zeros_like(row)])):
        pool = ex.make_pool(1 + WIDTH, PAGE)
        _, pool = ex.prefill_paged(tokens[:1], pool, row, length=24)
        tok = np.array([[3], [5]])[: len(bt)]
        logits, pool = ex.decode_paged(tok, pool, bt, np.array([24, 0])[: len(bt)])
        pools.append((logits[:1], pool))
    torch.testing.assert_close(pools[1][0], pools[0][0], **TOL)
    for n in ("k", "v"):
        torch.testing.assert_close(pools[1][1]["groups"]["b0_attn"][n][:, 1:],
                                   pools[0][1]["groups"]["b0_attn"][n][:, 1:],
                                   **TOL)


def test_scheduler_auto_pages_the_dense_zoo(zoo):
    """"auto" serves a dense arch by continuous batching: the same greedy
    tokens as waves in fewer decode steps on a skewed mix."""
    def run(scheduler):
        eng = ServingEngine(zoo["ex"], max_batch=2, max_len=32, scheduler=scheduler,
                            page_size=4)
        for i in range(6):
            eng.submit(Request(uid=i, prompt=[1 + i] * 8,
                               max_new_tokens=12 if i % 3 == 0 else 2))
        return {r.uid: r.output for r in eng.run()}, eng.stats

    auto, auto_stats = run("auto")
    wave, wave_stats = run("wave")
    assert auto == wave
    assert auto_stats["decode_steps"] < wave_stats["decode_steps"]
    assert auto_stats["prefill_oneshots"] == 6


# --- the serve CLI -----------------------------------------------------------------

def test_serve_cli_dense_zoo_with_prefix_cache_on_cpu():
    """``launch.serve --executor zoo --model stablelm-12b --reduce`` with
    the prefix cache and chunks: continuous batching, hits on the shared
    system prompt, computed + cached prompt tokens == the prompt total."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        launch_serve.main(["--executor", "zoo", "--model", "stablelm-12b", "--reduce",
                           "--device", "cpu", "--requests", "5", "--prompt-len", "9-20",
                           "--shared-prefix", "32", "--prefix-cache", "on",
                           "--prefill-chunk", "16", "--max-new", "3", "--max-batch", "2"])
    lines = buf.getvalue().strip().splitlines()
    assert lines[0].startswith("stablelm-12b-smoke: 2 layers")
    assert lines[0].endswith("continuous scheduler")
    out = json.loads(lines[-1])
    st = out["stats"]
    assert out["new_tokens"] == 15
    assert st["prefix_hits"] >= 1 and st["prefill_chunks"] > 0
    assert out["prefix_stats"]["hits"] >= 1
    rng = np.random.default_rng(0)
    lens = rng.integers(9, 21, size=5)
    assert st["prefill_tokens"] + st["cached_prefix_tokens"] == 5 * 32 + int(lens.sum())


def test_serve_refuses_what_it_cannot_serve():
    with pytest.raises(ValueError, match=r"qwen1.5-110b needs 222.4 GB of bfloat16"):
        launch_serve.serve("qwen1.5-110b", executor_kind="zoo", device="cpu")
    with pytest.raises(ValueError, match="continuous"):
        launch_serve.serve("stablelm-12b", executor_kind="zoo", reduce=True, device="cpu",
                           requests=1, prompt_len=(4, 4), max_new=1, scheduler="wave",
                           prefix_cache=True)
    with pytest.raises(ValueError, match="unknown scheduler"):
        launch_serve.serve("stablelm-12b", executor_kind="zoo", reduce=True, device="cpu",
                           scheduler="fifo")
