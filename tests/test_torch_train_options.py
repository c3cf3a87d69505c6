"""The last training options of the reference, in the port, against the
reference: query-chunked attention (``cfg.attn_chunk``), remat "dots"
(``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``), dropout in
train mode, and fp8 weights.

Both packages get the same weights (the reference's tree drawn with
numpy, ``torch_helpers.numpy_params``) and the same inputs.  jax.random
bits have no torch twin, so dropout parity hands the port the
reference's own masks (``jax.random.bernoulli`` of ``fold_in(rng,
layer)``, through numpy) in a ``DropoutStream`` subclass.

Tolerances, fp32: chunked attention and logits 1e-5; loss and gradients
under "dots" bitwise equal to "full" in the port, and within 1e-5
(relative, the tree's 2-norm; the loss 1e-5 relative) of ``jax.grad``
under the reference's "dots"; dropout logits 1e-6 of the largest logit
(weights at the init scale; the same fp32 noise as with dropout off);
fp8 weights bit for bit.  The "dots" save rule is held op by op to the reference's
``dot_general`` batch dimensions on every block kind.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import dataclasses  # noqa: E402
import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils.checkpoint import CheckpointPolicy  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import apply_model as j_apply_model  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models.attention import _chunked_causal_attention as j_chunked  # noqa: E402
from repro.models.transformer import _apply_block as j_apply_block  # noqa: E402
from repro.training.train_loop import loss_fn as j_loss_fn  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import apply_model, params_from_numpy  # noqa: E402
from repro_torch.models.attention import _attention  # noqa: E402
from repro_torch.models.layers import (DropoutStream, apply_dropout, dropout,  # noqa: E402
                                       dropout_mask)
from repro_torch.models.params import _leaves, abstract_params, group_params  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.models.transformer import _apply_block, dots_policy  # noqa: E402
from repro_torch.training.optimizer import tree_leaves  # noqa: E402
from repro_torch.training.train_loop import loss_fn  # noqa: E402
from torch_helpers import numpy_params  # noqa: E402

B, S = 2, 16
ARCHS = ("qwen1.5-0.5b", "recurrentgemma-9b", "olmoe-1b-7b", "xlstm-350m",
         "llama-3.2-vision-90b")


def _cfgs(arch, **over):
    return (dataclasses.replace(j_reduced(j_get_config(arch)), **over),
            dataclasses.replace(reduced(get_config(arch)), **over))


def _inputs(cfg, seed=0):
    """Model inputs (numpy) and labels of a reduced arch."""
    rng = np.random.default_rng(seed)
    kw = {}
    if cfg.input_mode == "token":
        kw["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    else:
        kw["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    if cfg.num_image_tokens:
        kw["img_embeds"] = rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    shape = (B, S, cfg.num_codebooks) if cfg.num_codebooks > 1 else (B, S)
    labels = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    return kw, labels


def _t(kw):
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in kw.items()}


def _tree_rel(got, want):
    num = sum(float(((g.double() - torch.from_numpy(np.asarray(w, np.float64))) ** 2).sum())
              for g, w in zip(got, want))
    den = sum(float((np.asarray(w, np.float64) ** 2).sum()) for w in want)
    return (num / den) ** 0.5


# --- query-chunked attention ---------------------------------------------------

@functools.lru_cache(maxsize=None)
def _j_chunked(window, chunk, heads, kv):
    jcfg = dataclasses.replace(j_reduced(j_get_config("qwen1.5-0.5b")), num_heads=heads,
                               num_kv_heads=kv, attn_chunk=chunk)
    return jax.jit(lambda q, k, v, pos: j_chunked(q, k, v, pos, window, jcfg))


@pytest.mark.parametrize("heads,kv,window,chunk", [(4, 2, 0, 4), (4, 1, 6, 8), (4, 4, 0, 8)])
def test_chunked_attention_matches_reference(heads, kv, window, chunk):
    rng = np.random.default_rng(3)
    hd = 8
    q = rng.standard_normal((B, S, heads, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, kv, hd)).astype(np.float32) for _ in range(2))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want = np.asarray(_j_chunked(window, chunk, heads, kv)(q, k, v, pos))
    qt, kt, vt = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    got = _attention(qt, kt, vt, causal=True, window=window, backend="eager", chunk=chunk)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, atol=1e-5, rtol=0)
    # and the same numbers as the whole attention
    whole = _attention(qt, kt, vt, causal=True, window=window, backend="eager")
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-6, rtol=0)


def test_chunked_attention_gradient_equals_whole():
    """The chunked backward (P and dP a chunk at a time, dK/dV summed over
    the chunks) gives the whole attention's gradients."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in [(B, 4, S, 8), (B, 2, S, 8), (B, 2, S, 8)])
    dout = torch.from_numpy(rng.standard_normal((B, 4, S, 8)).astype(np.float32))
    grads = []
    for chunk in (0, 4):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        out = _attention(*ins, causal=True, window=0, backend="eager", chunk=chunk)
        grads.append(torch.autograd.grad(out, ins, dout))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_model_with_attn_chunk_matches_reference():
    jcfg, cfg = _cfgs("qwen1.5-0.5b", attn_chunk=4)
    tree = numpy_params(jcfg)
    kw, _ = _inputs(cfg)
    want, _, _ = jax.jit(lambda p, t: j_apply_model(p, jcfg, tokens=t, mode="train"))(
        tree, kw["tokens"])
    got, _ = apply_model(params_from_numpy(tree), cfg, mode="train", backend="eager",
                         **_t(kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="attn_chunk"):
        apply_model(params_from_numpy(tree), dataclasses.replace(cfg, attn_chunk=5),
                    mode="train", backend="eager", **_t(kw))


# --- remat "dots" ----------------------------------------------------------------

_PRODUCTS = {torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.mv, torch.ops.aten.dot,
             torch.ops.aten.bmm, torch.ops.aten.baddbmm}


class _RuleLog(TorchDispatchMode):
    """Each product's output size, split by what ``dots_policy`` does."""

    def __init__(self):
        super().__init__()
        self.saved, self.recomputed = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func._overloadpacket in _PRODUCTS:
            keep = dots_policy(None, func, *args, **kwargs) == CheckpointPolicy.MUST_SAVE
            (self.saved if keep else self.recomputed).append(out.numel())
        return out


def _jax_products(jaxpr, saved, batched):
    """Output sizes of the ``dot_general``s of a jaxpr (sub-jaxprs
    included), split by whether they have batch dimensions."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (_, _), (lb, _) = eqn.params["dimension_numbers"]
            (batched if lb else saved).append(int(np.prod(eqn.outvars[0].aval.shape)))
        for v in eqn.params.values():
            for u in (v if isinstance(v, (tuple, list)) else [v]):
                sub = getattr(u, "jaxpr", u)
                if hasattr(sub, "eqns"):
                    _jax_products(sub, saved, batched)


BLOCKS = [("qwen1.5-0.5b", 0), ("recurrentgemma-9b", 0), ("recurrentgemma-9b", 2),
          ("olmoe-1b-7b", 0), ("xlstm-350m", 0), ("xlstm-350m", 1),
          ("llama-3.2-vision-90b", 4)]


@pytest.mark.parametrize("arch,index", BLOCKS)
def test_dots_saves_the_products_jax_saves(arch, index):
    """Per block kind (attn, rec, moe, mlstm, slstm, xattn): the products
    the port's rule saves are, by output size, exactly the reference's
    ``dot_general``s with no batch dimension, and each product it
    recomputes has the size of a batched one there (attention's QK^T and
    PV, the MoE's dispatch, expert and combine contractions, the per-head
    recurrences; the xLSTM loops split theirs by chunk or step)."""
    jcfg, cfg = _cfgs(arch)
    kind = cfg.block_pattern[index]
    key = f"b{index}_{kind}"
    tree = numpy_params(jcfg)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    img = rng.standard_normal((B, max(cfg.num_image_tokens, 1), cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jp = jax.tree.map(lambda a: a[0], tree["groups"][key])
    jaxpr = jax.make_jaxpr(lambda p, x: j_apply_block(
        kind, p, x, jcfg, mode="train", cache=None, positions=jnp.asarray(pos),
        cache_index=None, rng=None, deterministic=True, img_embeds=jnp.asarray(img)))(
        jp, jnp.asarray(x))
    j_saved, j_batched = [], []
    _jax_products(jaxpr.jaxpr, j_saved, j_batched)
    p = group_params(params_from_numpy(tree), 0)[key]
    with _RuleLog() as log:
        _apply_block(kind, p, torch.from_numpy(x), cfg, mode="train", cache=None,
                     positions=torch.from_numpy(pos.copy()), cache_index=None,
                     backend="eager", img_embeds=torch.from_numpy(img))
    assert sorted(log.saved) == sorted(j_saved)
    assert set(log.recomputed) <= set(j_batched)
    assert log.saved


def _port_loss_and_grads(cfg, params, kw, labels, seed=None, backend="eager"):
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, _ = loss_fn(params, {**_t(kw), "labels": torch.from_numpy(labels)}, cfg,
                          backend=backend, seed=seed)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


@pytest.mark.parametrize("arch", ARCHS + ("granite-moe-3b-a800m", "musicgen-medium"))
def test_dots_loss_and_gradients_equal_full(arch):
    _, cfg = _cfgs(arch)
    params = init_params(cfg, generator=torch.Generator().manual_seed(0))
    kw, labels = _inputs(cfg)
    out = {pol: _port_loss_and_grads(dataclasses.replace(cfg, remat=True, remat_policy=pol),
                                     params, kw, labels)
           for pol in ("full", "dots")}
    assert torch.equal(out["dots"][0], out["full"][0])
    assert all(torch.equal(a, b) for a, b in zip(out["dots"][1], out["full"][1]))


@functools.lru_cache(maxsize=None)
def _j_grad(arch, policy, dropout_rate=0.0):
    jcfg = dataclasses.replace(j_reduced(j_get_config(arch)), remat=True,
                               remat_policy=policy, dropout_rate=dropout_rate)
    return jax.jit(jax.value_and_grad(lambda p, b, r: j_loss_fn(p, b, jcfg, r)[0]))


@pytest.mark.parametrize("arch", ["recurrentgemma-9b"])
def test_dots_gradients_match_reference_dots(arch):
    jcfg, cfg = _cfgs(arch, remat=True, remat_policy="dots")
    tree = numpy_params(jcfg, boost=1.0)
    kw, labels = _inputs(cfg)
    want_loss, want = _j_grad(arch, "dots")(tree, {**kw, "labels": labels}, None)
    loss, grads = _port_loss_and_grads(cfg, params_from_numpy(tree), kw, labels)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    want_leaves = [leaf for _, leaf in _leaves(jax.tree.map(np.asarray, want))]
    assert _tree_rel(grads, want_leaves) < 1e-5


def test_unknown_remat_policy_is_refused():
    _, cfg = _cfgs("qwen1.5-0.5b")
    params = init_params(cfg, generator=torch.Generator().manual_seed(0))
    kw, _ = _inputs(cfg)
    with pytest.raises(NotImplementedError, match="remat_policy"):
        apply_model(params, dataclasses.replace(cfg, remat=True, remat_policy="offload"),
                    **_t(kw))


# --- dropout ----------------------------------------------------------------------

class _ReferenceMasks(DropoutStream):
    """The reference's masks: layer ``i`` of a step with key ``rng`` draws
    ``bernoulli(fold_in(rng, i), 1 - rate, shape)`` at each of its sites.
    Records every request, forward and recompute."""

    def __init__(self, key):
        super().__init__(0)
        self.key = key
        self.calls = []

    def mask(self, layer, site, shape, rate, device):
        m = jax.random.bernoulli(jax.random.fold_in(self.key, layer), 1.0 - rate, tuple(shape))
        t = torch.from_numpy(np.array(m)).to(device)
        self.calls.append((layer, site, t))
        return t


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "xlstm-350m"])
def test_dropout_with_reference_masks_matches_reference(arch):
    jcfg, cfg = _cfgs(arch, dropout_rate=0.1)
    tree = numpy_params(jcfg, boost=1.0)
    kw, _ = _inputs(cfg)
    key = jax.random.PRNGKey(7)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    want, _, _ = jax.jit(lambda p, r: j_apply_model(p, jcfg, mode="train", rng=r,
                                                    deterministic=False, **jkw))(tree, key)
    stream = _ReferenceMasks(key)
    got, _ = apply_model(params_from_numpy(tree), cfg, mode="train", backend="eager",
                         generator=stream, deterministic=False, **_t(kw))
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    # every connective site drew one mask (an attention or recurrent block
    # and its FFN two, an xLSTM block one), and the masks dropped something
    ffn = cfg.is_moe or cfg.d_ff > 0
    assert [(layer, site) for layer, site, _ in stream.calls] == [
        (layer, site) for layer, kind in enumerate(cfg.layer_kinds())
        for site in range(2 if kind in ("attn", "xattn", "rec") and ffn else 1)]
    assert not all(bool(m.all()) for _, _, m in stream.calls)
    # deterministic (the default) and dropout off give the same logits
    off, _ = apply_model(params_from_numpy(tree), dataclasses.replace(cfg, dropout_rate=0.0),
                         mode="train", backend="eager", **_t(kw))
    same, _ = apply_model(params_from_numpy(tree), cfg, mode="train", backend="eager",
                          generator=stream, **_t(kw))
    assert torch.equal(off, same)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_dropout_mask_is_the_same_in_forward_and_recompute(policy):
    """Under remat each group's masks are drawn again in the recompute
    (from generators seeded by the step seed, layer and site), equal to
    the forward's; so the gradients equal those of a step that keeps
    every activation, bitwise."""
    _, cfg = _cfgs("qwen1.5-0.5b", dropout_rate=0.1)
    params = init_params(cfg, generator=torch.Generator().manual_seed(0))
    kw, labels = _inputs(cfg)

    class Logged(DropoutStream):
        calls = []

        def mask(self, layer, site, shape, rate, device):
            m = super().mask(layer, site, shape, rate, device)
            self.calls.append(((layer, site), m))
            return m

    runs = {}
    for pol in (policy, "none"):
        c = dataclasses.replace(cfg, remat=pol != "none", remat_policy=pol)
        Logged.calls = []
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        logits, _ = apply_model(params, c, mode="train", backend="eager",
                                generator=Logged(11), deterministic=False, **_t(kw))
        grads = torch.autograd.grad(logits.square().mean(), leaves)
        for t in leaves:
            t.requires_grad_(False)
        runs[pol] = (grads, list(Logged.calls))
    calls = runs[policy][1]
    first = {}
    for where, m in calls:
        if where in first:
            assert torch.equal(first[where], m)
        first.setdefault(where, m)
    assert len(calls) == 2 * len(first)  # drawn in the forward and the recompute
    assert all(torch.equal(a, b) for a, b in zip(runs[policy][0], runs["none"][0]))
    # the train step's seed: the same seed the same loss, another seed another
    losses = [_port_loss_and_grads(cfg, params, kw, labels, seed=s)[0] for s in (3, 3, 4)]
    assert torch.equal(losses[0], losses[1]) and not torch.equal(losses[0], losses[2])


def test_dropout_pieces():
    x = torch.ones(64, 64)
    gen = torch.Generator().manual_seed(0)
    keep = dropout_mask(x.shape, 0.25, gen)
    assert keep.dtype == torch.bool and 0.6 < float(keep.float().mean()) < 0.9
    out = apply_dropout(x, keep, 0.25)
    assert torch.equal(out, torch.where(keep, x / 0.75, torch.zeros(())))
    assert dropout(x, 0.25, gen, deterministic=True) is x
    assert dropout(x, 0.0, gen, deterministic=False) is x
    assert dropout(x, 0.25, None, deterministic=False) is x
    a = DropoutStream(5).mask(2, 1, (8, 8), 0.5, "cpu")
    assert torch.equal(a, DropoutStream(5).mask(2, 1, (8, 8), 0.5, "cpu"))
    assert not torch.equal(a, DropoutStream(5).mask(2, 0, (8, 8), 0.5, "cpu"))


# --- fp8 weights ------------------------------------------------------------------

def test_fp8_params_round_trip_reference_values():
    jcfg, cfg = _cfgs("qwen1.5-0.5b", param_dtype="float8_e4m3fn")
    tree = jax.jit(lambda k: j_init_params(jcfg, k))(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, tree))
    for (path, got), (_, want) in zip(_leaves(params),
                                      _leaves(jax.tree.map(np.asarray, tree))):
        assert got.dtype == torch.float8_e4m3fn, path
        np.testing.assert_array_equal(got.view(torch.uint8).numpy(), want.view(np.uint8))
    # weights are cast to the compute dtype at use, as jnp promotion does
    kw, _ = _inputs(cfg)
    want, _, _ = jax.jit(lambda p, t: j_apply_model(p, jcfg, tokens=t, mode="train"))(
        tree, kw["tokens"])
    got, _ = apply_model(params, cfg, mode="train", backend="eager", **_t(kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # drawn in fp32 and cast; the abstract tree takes the dtype too
    drawn = init_params(cfg, generator=torch.Generator().manual_seed(0))
    assert all(t.dtype == torch.float8_e4m3fn for t in tree_leaves(drawn))
    assert all(t.dtype == torch.float8_e4m3fn for t in tree_leaves(abstract_params(cfg)))
