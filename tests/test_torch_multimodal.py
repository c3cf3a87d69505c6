"""The port's multimodal zoo against the reference's: musicgen-medium
(``embed`` input, sinusoidal positions, 4 codebook heads) and
llama-3.2-vision-90b (``xattn`` cross-attention to image embeddings), on
their reduced configs.  ``sinusoidal_pos``, ``cross_attention_block``
(train and prefill, then decode from the frozen image K/V), train-mode
logits of ``apply_model``, and prefill then decode against the port's own
forward at the reference's ``TOL`` 2e-5 (``tests/test_decode_equivalence.py``).

Both packages get the same weights (``torch_helpers.numpy_params``: the
cross-attention gate and every norm nonzero) and the same inputs from
numpy.  Tolerance against the reference: 1e-4 absolute and relative in
fp32 (matmuls and softmax summed in another order).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import dataclasses  # noqa: E402
import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import apply_model as j_apply_model  # noqa: E402
from repro.models.attention import cross_attention_block as _j_xattn  # noqa: E402
from repro.models.layers import sinusoidal_pos as j_sinusoidal_pos  # noqa: E402
from repro.models.params import PSpec as JPSpec  # noqa: E402
from repro.models.params import model_spec as j_model_spec  # noqa: E402
from repro.serving.kvcache import cache_bytes as j_cache_bytes  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS, get_config, reduced  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import apply_model, model_spec, params_from_numpy  # noqa: E402
from repro_torch.models.attention import cross_attention_block  # noqa: E402
from repro_torch.models.layers import sinusoidal_pos  # noqa: E402
from repro_torch.models.params import group_params  # noqa: E402
from repro_torch.serving.kvcache import cache_bytes, make_cache  # noqa: E402
from torch_helpers import numpy_params  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
DECODE_TOL = 2e-5
ARCHS = ("musicgen-medium", "llama-3.2-vision-90b")
B, S = 2, 12


@functools.lru_cache(maxsize=None)
def _model(arch):
    jcfg, cfg = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    tree = numpy_params(jcfg)
    rng = np.random.default_rng(7)
    inputs = {}
    if cfg.input_mode == "token":
        inputs["tokens"] = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    else:
        inputs["embeds"] = (rng.standard_normal((B, S, cfg.d_model)) * 0.5).astype(np.float32)
    if cfg.num_image_tokens:
        inputs["img_embeds"] = rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, tree, inputs


def _spec_shapes(tree, is_leaf, shape_of, path=()):
    out = {}
    for key, val in tree.items():
        if is_leaf(val):
            out[path + (key,)] = shape_of(val)
        else:
            out.update(_spec_shapes(val, is_leaf, shape_of, path + (key,)))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_tree_match_reference(arch):
    """Config fields the port has, parameter counts, cache bytes and the
    parameter tree's shapes and initializers equal the reference's, full
    and reduced; both configs are among the trainer's ``ASSIGNED_ARCHS``."""
    assert arch in ASSIGNED_ARCHS
    full, jfull = get_config(arch), j_get_config(arch)
    for small, jsmall in ((full, jfull), (reduced(full), j_reduced(jfull))):
        for f in dataclasses.fields(small):
            assert getattr(small, f.name) == getattr(jsmall, f.name), f.name
        assert small.param_count() == jsmall.param_count()
        assert cache_bytes(small, 2, 40) == j_cache_bytes(jsmall, 2, 40)
        got = _spec_shapes(model_spec(small), lambda v: not isinstance(v, dict),
                           lambda ps: ps.shape + (ps.init,))
        want = _spec_shapes(j_model_spec(jsmall), lambda v: isinstance(v, JPSpec),
                            lambda ps: ps.shape + (ps.init,))
        assert got == want


def test_sinusoidal_pos_matches_reference():
    """Within 1e-5 plus the angle's rounding: p * f carries up to 2 p
    ulp(f) when the two libraries round the fp32 frequency f = exp(.)
    one unit apart, 4 p 2^-24 in all (4e-4 at p = 4095)."""
    pos = np.array([[0, 1, 5, 300], [7, 8, 9, 4095]], np.int32)
    atol = 1e-5 + 4 * pos.max(axis=1, keepdims=True)[..., None] * 2.0 ** -24
    for d in (64, 1536):
        want = np.asarray(j_sinusoidal_pos(jnp.asarray(pos), d))
        got = sinusoidal_pos(torch.from_numpy(pos), d)
        assert got.shape == (2, 4, d) and got.dtype == torch.float32
        assert (np.abs(got.numpy() - want) <= atol).all()


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_cross_attention_block_matches_reference(qkv_bias):
    """Train and prefill outputs against the reference, the prefill's
    cache equal to the image K/V, and a decode row reading the frozen
    cache equal to the same row of the prefill."""
    jcfg, cfg, tree, inputs = _model("llama-3.2-vision-90b")
    jcfg = dataclasses.replace(jcfg, qkv_bias=qkv_bias)
    cfg = dataclasses.replace(cfg, qkv_bias=qkv_bias)
    tree = numpy_params(jcfg)
    jp = jax.tree.map(lambda t: jnp.asarray(t[0]), tree["groups"]["b4_xattn"])
    p = group_params(params_from_numpy(tree), 0)["b4_xattn"]
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    img = inputs["img_embeds"]
    j_xattn = jax.jit(_j_xattn, static_argnums=2, static_argnames=("mode", "deterministic"))
    want, _ = j_xattn(jp, jnp.asarray(x), jcfg, mode="train", img_embeds=jnp.asarray(img),
                      cache=None, rng=None, deterministic=True)
    got, c = cross_attention_block(p, torch.from_numpy(x), cfg, mode="train",
                                   img_embeds=torch.from_numpy(img), cache=None)
    assert c is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    cache = make_cache(cfg, B, S)["groups"]["b4_xattn"]
    cache = {n: t[0] for n, t in cache.items()}
    assert cache["k"].shape == (B, cfg.num_image_tokens, cfg.num_kv_heads, cfg.head_dim)
    pre, c = cross_attention_block(p, torch.from_numpy(x), cfg, mode="prefill",
                                   img_embeds=torch.from_numpy(img), cache=cache)
    assert c is cache and cache["k"].abs().sum() > 0
    torch.testing.assert_close(pre, got, atol=0, rtol=0)
    _, jc = j_xattn(jp, jnp.asarray(x), jcfg, mode="prefill", img_embeds=jnp.asarray(img),
                    cache=None, rng=None, deterministic=True)
    for n in ("k", "v"):
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(jc[n]), **TOL)
    dec, c = cross_attention_block(p, torch.from_numpy(x[:, 5:6]), cfg, mode="decode",
                                   img_embeds=None, cache=cache)
    assert c is cache
    torch.testing.assert_close(dec[:, 0], got[:, 5], atol=DECODE_TOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_match_reference(arch):
    """``apply_model`` train-mode logits, (B, S, 4, V) for musicgen's
    codebook heads and (B, S, V) for llama-vision, against the
    reference's."""
    jcfg, cfg, tree, inputs = _model(arch)
    want, _, _ = jax.jit(functools.partial(j_apply_model, cfg=jcfg, mode="train"))(
        jax.tree.map(jnp.asarray, tree), **{k: jnp.asarray(v) for k, v in inputs.items()})
    got, cache = apply_model(params_from_numpy(tree), cfg, mode="train", **inputs)
    assert cache is None
    shape = (B, S, 4, cfg.vocab_size) if arch == "musicgen-medium" else (B, S, cfg.vocab_size)
    assert tuple(got.shape) == shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_forward(arch):
    """Prefill of the first S - 3 rows, then 3 decode steps (positions
    from the cache index; llama-vision's image K/V read back from the
    cache), against the train-mode forward at the reference's TOL."""
    _, cfg, tree, inputs = _model(arch)
    params = params_from_numpy(tree)
    ref, _ = apply_model(params, cfg, mode="train", **inputs)
    main = "tokens" if "tokens" in inputs else "embeds"
    img = {k: v for k, v in inputs.items() if k == "img_embeds"}
    s0 = S - 3
    cache = make_cache(cfg, B, S)
    pl, cache = apply_model(params, cfg, mode="prefill", cache=cache,
                            **{main: inputs[main][:, :s0]}, **img)
    torch.testing.assert_close(pl, ref[:, :s0], atol=DECODE_TOL, rtol=0)
    for t in range(s0, S):
        dl, cache = apply_model(params, cfg, mode="decode", cache=cache, cache_index=t,
                                **{main: inputs[main][:, t:t + 1]})
        torch.testing.assert_close(dl[:, 0], ref[:, t], atol=DECODE_TOL, rtol=0)


def test_img_embeds_required_for_vlm():
    _, cfg, tree, inputs = _model("llama-3.2-vision-90b")
    with pytest.raises(ValueError, match="img_embeds"):
        apply_model(params_from_numpy(tree), cfg, tokens=inputs["tokens"])


@pytest.mark.parametrize("arch,match", [("musicgen-medium", "stub-frontend"),
                                        ("llama-3.2-vision-90b", "image embeddings")])
def test_serve_refuses_the_frontend_stub_archs(arch, match):
    with pytest.raises(ValueError, match=match):
        launch_serve.serve(arch, executor_kind="zoo", reduce=True, device="cpu")
