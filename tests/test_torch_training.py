"""The port's training path against the reference's: the NLL and
cross-entropy (forward and gradient), AdamW and the cosine schedule, one
train step for six reduced architectures, the gradients of the flash
attention and RG-LRU scan ``autograd.Function``s, rematerialization, and
checkpoints across the two packages.

Both packages get the same weights (the reference's tree drawn with
numpy, ``torch_helpers.numpy_params``) and the same batch (the data
pipeline, bitwise equal in both).  The reference runs on the CPU under
``jax.jit``, once per (arch, function).

Tolerances, all fp32: loss and grad norm within 1e-5 relative; gradients
within 1e-5 relative in the 2-norm over the tree, and each leaf within
1e-4 of its largest (a scalar leaf such as the cross-attention gate sums
every position's contribution, with cancellation); updated params within
1e-5 relative in the 2-norm over the tree.  Adam's first step is g / (|g| + eps) per
element, so an element whose gradient is zero in exact arithmetic (the
key bias under softmax, for one) moves by lr x noise / eps in either
package: the elementwise error of such a leaf is no measure of the
port, the tree's norm is.  Cross-entropy and the attention and scan
gradients: 1e-5 absolute on O(1) values (sums in another order).
"""
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread, so the xdist workers beside it keep their cores
torch.set_num_threads(1)

import dataclasses  # noqa: E402
import functools  # noqa: E402
import io  # noqa: E402
from contextlib import redirect_stdout  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import LMDataPipeline as JLMDataPipeline  # noqa: E402
from repro.kernels.ref import flash_attention_ref as j_flash_ref  # noqa: E402
from repro.models import apply_model as j_apply_model  # noqa: E402
from repro.models.rglru import rglru_scan as j_rglru_scan  # noqa: E402
from repro.training import AdamW as JAdamW  # noqa: E402
from repro.training import cosine_schedule as j_cosine_schedule  # noqa: E402
from repro.training import make_train_step as j_make_train_step  # noqa: E402
from repro.training import save_checkpoint as j_save_checkpoint  # noqa: E402
from repro.training.train_loop import cross_entropy as j_cross_entropy  # noqa: E402
from repro.training.train_loop import loss_fn as j_loss_fn  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data import DataConfig, LMDataPipeline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan_plain  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import apply_model, params_from_numpy  # noqa: E402
from repro_torch.models.params import _leaves  # noqa: E402
from repro_torch.training import (  # noqa: E402
    AdamW,
    cosine_schedule,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.training.optimizer import tree_leaves  # noqa: E402
from repro_torch.training.train_loop import (  # noqa: E402
    batch_to_device,
    cross_entropy,
    loss_fn,
)
from torch_helpers import flat_tree, numpy_params  # noqa: E402

TRAIN_ARCHS = ("qwen1.5-0.5b", "musicgen-medium", "llama-3.2-vision-90b", "olmoe-1b-7b",
               "recurrentgemma-9b", "xlstm-350m")
REL = 1e-5
B, S = 2, 16


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _batch(jcfg, cfg, seed=0):
    """One batch of each package's pipeline (asserted equal) as numpy."""
    kw = dict(batch_size=B, seq_len=S, seed=seed)
    want = next(iter(JLMDataPipeline(jcfg, JDataConfig(**kw))))
    got = next(iter(LMDataPipeline(cfg, DataConfig(**kw))))
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    return got


def _setup(arch):
    jcfg, cfg = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    return jcfg, cfg, numpy_params(jcfg, boost=1.0), _batch(jcfg, cfg)


@functools.lru_cache(maxsize=None)
def _j_step(arch):
    """The reference's optimizer and jitted train step of a reduced arch."""
    jcfg = j_reduced(j_get_config(arch))
    opt = JAdamW(j_cosine_schedule(1e-3, 2, 10))
    return opt, jax.jit(j_make_train_step(jcfg, opt))


def _tree_rel(port: dict, ref: dict) -> float:
    num = den = 0.0
    for key, want in ref.items():
        diff = port[key].astype(np.float64) - want
        num += float((diff ** 2).sum())
        den += float((want.astype(np.float64) ** 2).sum())
    return (num / den) ** 0.5


def _port_flat(params) -> dict:
    return {"/".join(path): leaf.detach().numpy() for path, leaf in _leaves(params)}


# --- the NLL and cross-entropy ------------------------------------------------

@pytest.mark.parametrize("codebooks", [0, 4])
def test_cross_entropy_and_gradient_match_reference(codebooks):
    rng = np.random.default_rng(1)
    v = 300
    shape = (B, 7, codebooks, v) if codebooks else (B, 7, v)
    logits = (rng.standard_normal(shape) * 3).astype(np.float32)
    labels = rng.integers(0, v, size=shape[:-1]).astype(np.int32)
    labels[0, :3] = -1  # padding
    jcfg = j_reduced(j_get_config("musicgen-medium" if codebooks else "qwen1.5-0.5b"))
    cfg = reduced(get_config(jcfg.name[:-len("-smoke")]))
    want, jgrad = jax.value_and_grad(j_cross_entropy)(jnp.asarray(logits),
                                                      jnp.asarray(labels), jcfg)
    t = torch.from_numpy(logits).requires_grad_()
    got = cross_entropy(t, torch.from_numpy(labels), cfg)
    got.backward()
    assert _rel(float(got.detach()), float(want)) < REL
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), atol=1e-6, rtol=1e-5)
    # padded rows get no gradient
    assert not t.grad[0, :3].any()


def test_nll_bf16_against_fp32_log_softmax():
    """The bf16 NLL (shifted exponentials in bf16, fp32 sums) and its
    gradient against fp32 autograd of ``log_softmax`` from the same bf16
    logits: the loss within 2e-2 (bf16 shifted exponentials summed in
    fp32), each gradient within 4e-2 relative: the shift x - m is rounded
    to bf16 (the reference's one-buffer design), so exp(x - m) carries up
    to 2^-9 |x - m| of relative error, and |x - m| < 16 here; then three
    bf16 roundings of 2^-9 (the exponential, the division, the product
    with g)."""
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.standard_normal((3, 5, 1000)).astype(np.float32) * 2)
    labels = torch.from_numpy(rng.integers(0, 1000, size=(3, 5)))
    lb = logits.to(torch.bfloat16).requires_grad_()
    ref_in = lb.detach().float().requires_grad_()
    cfg = reduced(get_config("qwen1.5-0.5b"))
    got = cross_entropy(lb, labels, cfg)
    want = torch.nn.functional.cross_entropy(ref_in.reshape(-1, 1000), labels.reshape(-1))
    got.backward()
    want.backward()
    assert lb.grad.dtype == torch.bfloat16
    assert abs(float(got.detach()) - float(want)) < 2e-2
    torch.testing.assert_close(lb.grad.float(), ref_in.grad, atol=1e-6, rtol=4e-2)


# --- AdamW and the schedule ----------------------------------------------------

def test_cosine_schedule_matches_reference():
    ours, ref = cosine_schedule(3e-4, 10, 100), j_cosine_schedule(3e-4, 10, 100)
    for step in [0, 1, 5, 9, 10, 11, 37, 64, 99, 100, 150]:
        want = float(ref(jnp.asarray(step, jnp.int32)))
        assert abs(ours(step) - want) <= 1e-7 * 3e-4, step


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_matches_reference(steps):
    """AdamW over ``steps`` steps with the global-norm clip active (the
    gradients' norm is ~8 against a clip of 1)."""
    rng = np.random.default_rng(3)
    tree = {"a": {"w": rng.standard_normal((6, 5)).astype(np.float32)},
            "b": rng.standard_normal((7,)).astype(np.float32)}
    grads = [{"a": {"w": rng.standard_normal((6, 5)).astype(np.float32)},
              "b": rng.standard_normal((7,)).astype(np.float32)} for _ in range(steps)]
    jopt = JAdamW(j_cosine_schedule(1e-2, 2, 10))
    opt = AdamW(cosine_schedule(1e-2, 2, 10))
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init(jp)
    p = params_from_numpy(tree)
    st = opt.init(p)
    for g in grads:
        jp, js, jm = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        p, st, m = opt.update([torch.from_numpy(x.copy()) for x in
                               (g["a"]["w"], g["b"])], st, p)
        assert float(jm["grad_norm"]) > 5.0  # the clip is active
        assert _rel(float(m["grad_norm"]), float(jm["grad_norm"])) < 1e-6
        assert abs(m["lr"] - float(jm["lr"])) <= 1e-9
    assert int(st.step) == int(js.step) == steps
    for got, want in ((p, jp), (st.mu, js.mu), (st.nu, js.nu)):
        for key, leaf in flat_tree(want).items():
            np.testing.assert_allclose(_port_flat(got)[key], leaf, rtol=1e-5, atol=1e-7)


# --- one train step per architecture -------------------------------------------

@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_matches_reference(arch):
    """One AdamW step of the reduced model: loss, grad norm, gradients and
    updated params against the reference's ``make_train_step``."""
    jcfg, cfg, tree, batch = _setup(arch)
    opt = AdamW(cosine_schedule(1e-3, 2, 10))
    jopt, j_step = _j_step(arch)
    jp = jax.tree.map(jnp.asarray, tree)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jp2, _, jm = j_step(jp, jopt.init(jp), jbatch, jax.random.PRNGKey(0))
    jgrads = flat_tree(jax.jit(jax.grad(lambda q, b: j_loss_fn(q, b, jcfg, None)[0]))(
        jp, jbatch))

    params = params_from_numpy(tree)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = loss_fn(params, batch_to_device(batch, None), cfg)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    got = {"/".join(path): g.numpy() for (path, _), g in zip(_leaves(params), grads)}
    for key, want in jgrads.items():
        err = np.abs(got[key] - want).max()
        assert err <= 10 * REL * max(np.abs(want).max(), 1e-12), (key, err)
    assert _tree_rel(got, jgrads) < REL

    params, st, m = make_train_step(cfg, opt)(params, opt.init(params),
                                              batch_to_device(batch, None))
    assert _rel(float(m["loss"]), float(jm["loss"])) < REL
    assert _rel(float(m["grad_norm"]), float(jm["grad_norm"])) < REL
    assert _tree_rel(_port_flat(params), flat_tree(jp2)) < REL
    assert int(st.step) == 1
    if cfg.is_moe:
        assert float(m["moe_lb_loss"]) > 0 and float(m["loss"]) > float(m["ce_loss"])


def test_remat_recomputes_to_the_same_gradients():
    """``cfg.remat`` (each group under ``torch.utils.checkpoint``) changes
    what is kept, not what is computed: gradients bitwise equal to the run
    that keeps every activation, on a 2-group RecurrentGemma (scan and
    flash Functions inside the recomputed groups)."""
    arch = "recurrentgemma-9b"
    jcfg = dataclasses.replace(j_reduced(j_get_config(arch)), num_layers=6)
    cfg = dataclasses.replace(reduced(get_config(arch)), num_layers=6)
    tree, batch = numpy_params(jcfg, boost=1.0), _batch(jcfg, cfg)
    out = []
    for remat in (False, True):
        params = params_from_numpy(tree)
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = loss_fn(params, batch_to_device(batch, None),
                          dataclasses.replace(cfg, remat=remat))
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_training_refuses_dropout_and_the_dots_policy():
    """Dropout and remat "dots" are ported (``tests/test_torch_train_options.py``
    holds them to the reference); what is still refused is a remat policy
    the reference does not have, and dropout runs only when a step asks
    for it (``deterministic=False`` and a generator), as the reference's
    ``rng``/``deterministic`` arguments decide."""
    _, cfg, tree, batch = _setup("qwen1.5-0.5b")
    params = params_from_numpy(tree)
    plain, _ = apply_model(params, cfg, tokens=batch["tokens"])
    with_rate, _ = apply_model(params, dataclasses.replace(cfg, dropout_rate=0.1),
                               tokens=batch["tokens"])
    assert torch.equal(plain, with_rate)
    with pytest.raises(NotImplementedError, match="remat_policy"):
        apply_model(params, dataclasses.replace(cfg, remat=True, remat_policy="offload"),
                    tokens=batch["tokens"])


# --- the kernels' autograd Functions ------------------------------------------

FLASH_CASES = {
    "causal_gqa": (2, 4, 2, 12, 12, 16, True, 0),
    "right_aligned": (1, 4, 1, 5, 13, 8, True, 0),
    "window_mqa": (2, 6, 1, 20, 20, 8, True, 6),
    "full": (1, 2, 2, 9, 9, 8, False, 0),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_function_gradient(case):
    """``ops.flash_attention`` with grad goes through ``FlashAttentionFn``
    (its forward the kernel wrapper, here its CPU plain version; its
    backward explicit torch ops): q, k, v gradients against autograd
    through the plain version and against ``jax.grad`` of the reference's
    oracle, on the zoo's transposed (B, S, H, hd) views."""
    b, h, hkv, sq, sk, hd, causal, window = FLASH_CASES[case]
    rng = np.random.default_rng(4)
    qn = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    kn, vn = (rng.standard_normal((b, sk, hkv, hd)).astype(np.float32) for _ in range(2))
    wn = rng.standard_normal((b, h, sq, hd)).astype(np.float32)

    def grads(fn):
        q, k, v = (torch.from_numpy(t).requires_grad_() for t in (qn, kn, vn))
        out = fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        (out * torch.from_numpy(wn)).sum().backward()
        return out, (q.grad, k.grad, v.grad)

    kw = dict(causal=causal, window=window)
    out, got = grads(lambda q, k, v: ops.flash_attention(q, k, v, **kw))
    assert out.grad_fn is not None and "FlashAttentionFn" in type(out.grad_fn).__name__
    _, plain = grads(lambda q, k, v: flash_attention_plain(q, k, v, **kw))
    jq, jk, jv = (jnp.asarray(t).transpose(0, 2, 1, 3) for t in (qn, kn, vn))
    jg = jax.jit(jax.grad(lambda q, k, v: jnp.sum(j_flash_ref(q, k, v, **kw) * wn),
                          argnums=(0, 1, 2)))(jq, jk, jv)
    for name, g, p, r in zip("qkv", got, plain, jg):
        r = np.asarray(r).transpose(0, 2, 1, 3)
        torch.testing.assert_close(g, p, atol=1e-5, rtol=1e-5, msg=name)
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5, rtol=1e-5, err_msg=name)


def test_flash_attention_without_grad_skips_the_function():
    q = torch.randn(1, 2, 4, 8)
    with torch.no_grad():
        assert ops.flash_attention(q, q, q).grad_fn is None
    assert ops.flash_attention(q, q, q).grad_fn is None


@pytest.mark.parametrize("shape", [(2, 9, 5), (1, 1, 3), (3, 17, 8)])
def test_rglru_scan_function_gradient(shape):
    """``ops.rglru_scan`` with grad goes through ``RGLRUScanFn`` (the plain
    scan forward, and backward on reversed time): da, db and dh0 against
    autograd through ``rglru_scan_plain`` and ``jax.grad`` of the
    reference's ``models/rglru.py`` associative scan, with a nonzero h0
    and gradients into both h_seq and h_last."""
    rng = np.random.default_rng(5)
    bsz, s, w = shape
    an = (0.5 + 0.5 * rng.random(shape)).astype(np.float32)
    bn = rng.standard_normal(shape).astype(np.float32)
    hn = rng.standard_normal((bsz, w)).astype(np.float32)
    w1 = rng.standard_normal(shape).astype(np.float32)
    w2 = rng.standard_normal((bsz, w)).astype(np.float32)

    def grads(fn):
        a, b, h0 = (torch.from_numpy(t).requires_grad_() for t in (an, bn, hn))
        hs, hl = fn(a, b, h0)
        ((hs * torch.from_numpy(w1)).sum() + (hl * torch.from_numpy(w2)).sum()).backward()
        return hs, (a.grad, b.grad, h0.grad)

    hs, got = grads(ops.rglru_scan)
    assert "RGLRUScanFn" in type(hs.grad_fn).__name__
    _, plain = grads(rglru_scan_plain)

    def jloss(a, b, h0):
        hs, hl = j_rglru_scan(a, b, h0)
        return jnp.sum(hs * w1) + jnp.sum(hl * w2)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(*(jnp.asarray(t) for t in (an, bn, hn)))
    for name, g, p, r in zip(("a", "b", "h0"), got, plain, jg):
        torch.testing.assert_close(g, p, atol=1e-5, rtol=1e-5, msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=1e-5,
                                   err_msg=name)


# --- checkpoints -------------------------------------------------------------

def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """A checkpoint the reference wrote after one step (params and AdamW
    state, the reference's key names) restores in the port: the same
    leaves, and logits equal to the reference's from the same weights."""
    arch = "llama-3.2-vision-90b"
    jcfg, cfg, tree, batch = _setup(arch)
    jopt, j_step = _j_step(arch)
    jp = jax.tree.map(jnp.asarray, tree)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jp2, js2, _ = j_step(jp, jopt.init(jp), jbatch, jax.random.PRNGKey(0))
    j_save_checkpoint(str(tmp_path), 1, jp2, js2, {"arch": jcfg.name})

    template = params_from_numpy(tree)
    opt = AdamW(cosine_schedule(1e-3, 2, 10))
    manifest, params, st = restore_checkpoint(str(tmp_path), template, opt.init(template))
    assert manifest == {"step": 1, "arch": jcfg.name}
    assert int(st.step) == 1
    for got, want in ((params, jp2), (st.mu, js2.mu), (st.nu, js2.nu)):
        got = _port_flat(got)
        for key, leaf in flat_tree(want).items():
            np.testing.assert_array_equal(got[key], leaf)
    want, _, _ = j_apply_model(jp2, jcfg, tokens=jbatch["tokens"],
                               img_embeds=jbatch["img_embeds"])
    logits, _ = apply_model(params, cfg, tokens=batch["tokens"],
                            img_embeds=batch["img_embeds"])
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_checkpoint_resume_continues_bitwise(tmp_path):
    """Three steps, a checkpoint, a restore into fresh tensors and three
    more steps give bitwise the params of six uninterrupted steps."""
    _, cfg, tree, _ = _setup("qwen1.5-0.5b")
    opt = AdamW(cosine_schedule(1e-3, 2, 6))
    step = make_train_step(cfg, opt)
    data = list(zip(range(6), LMDataPipeline(cfg, DataConfig(batch_size=B, seq_len=S))))

    def run(params, st, batches):
        for _, b in batches:
            params, st, _ = step(params, st, batch_to_device(b, None))
        return params, st

    full, _ = run(params_from_numpy(tree), opt.init(params_from_numpy(tree)), data)
    params = params_from_numpy(tree)
    params, st = run(params, opt.init(params), data[:3])
    save_checkpoint(str(tmp_path), 3, params, st)
    template = params_from_numpy(tree)
    _, params, st = restore_checkpoint(str(tmp_path), template, opt.init(template))
    params, _ = run(params, st, data[3:])
    for (path, a), (_, b) in zip(_leaves(full), _leaves(params)):
        assert torch.equal(a, b), "/".join(path)


# --- the entry point ---------------------------------------------------------

def test_train_cli_on_cpu(tmp_path):
    """``launch.train --reduce --device cpu`` trains, logs the reference's
    lines and writes a checkpoint."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = launch_train.main(["--arch", "musicgen-medium", "--reduce", "--d-model", "64",
                                 "--device", "cpu", "--steps", "4", "--batch", "2",
                                 "--seq", "16", "--log-every", "2", "--ckpt", str(tmp_path),
                                 "--ckpt-every", "4"])
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("training musicgen-medium-smoke: 2L d=64")
    assert lines[1].startswith("step     1 loss=") and "gnorm=" in lines[1] and "tok/s=" in lines[1]
    assert lines[-1].startswith("done: 4 steps, 128 tokens")
    assert len(out["losses"]) == 4 and all(np.isfinite(out["losses"]))
    assert (tmp_path / "params.npz").exists() and (tmp_path / "opt_state.npz").exists()


def test_trace_train_cli_on_cpu():
    """``launch.trace_train --reduce --device cpu`` runs warm, plain and
    profiled steps and says that no device time was recorded."""
    from repro_torch.launch import trace_train

    buf = io.StringIO()
    with redirect_stdout(buf):
        out = trace_train.main(["--arch", "xlstm-350m", "--reduce", "--device", "cpu",
                                "--steps", "1", "--batch", "2", "--seq", "8"])
    assert "device busy: not measured" in buf.getvalue()
    assert out["step_ms"] > 0 and out["peak_bytes"] is None


def test_train_refuses_what_does_not_fit_one_card():
    """Params + grads + fp32 moments at full size: the 1 B-ish archs
    train on one card, the large ones are refused, naming ``--reduce``."""
    for arch in ("qwen1.5-0.5b", "musicgen-medium", "xlstm-350m", "granite-moe-3b-a800m"):
        launch_train.check_fits_one_card(get_config(arch))
    for arch in ("llama-3.2-vision-90b", "qwen1.5-110b", "recurrentgemma-9b",
                 "olmoe-1b-7b", "codeqwen1.5-7b", "stablelm-12b"):
        with pytest.raises(ValueError, match="--reduce"):
            launch_train.check_fits_one_card(get_config(arch))
