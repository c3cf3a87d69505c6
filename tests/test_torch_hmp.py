"""The port's HMP layer and paged serving path against the reference, on
the uneven 3:2:2:1 plan of ``tests/test_execplan.py`` (heads 6/4/4/2,
columns 24/16/16/8, sequence shares 3:2:2:1).

Tolerances: fp32.  Layer outputs must be within 2e-5 of the reference's
``reference_layer`` (the bound of the reference's own uneven-plan test):
PyTorch's and XLA's CPU matmuls sum in different orders.  Stack logits
through 3 layers and the tied unembedding are held to 1e-4 for the same
reason, compounded over the layers.  Only valid rows are compared: pad
rows differ by design between the two backends.
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

PLAN = ExecPlan(heads=(6, 4, 4, 2), columns=(24, 16, 16, 8), head_dim=2,
                d_model=32, seq_shares=(3.0, 2.0, 2.0, 1.0))
RING = LocalRing(4)


@functools.lru_cache(maxsize=None)
def _layer_case(s: int):
    p = jhmp.init_layer_params(jax.random.PRNGKey(0), 32, 16, 64)
    x = np.random.default_rng(s).normal(size=(2, s, 32)).astype(np.float32) * 0.5
    ref = np.asarray(jax.jit(jhmp.reference_layer)(p, jnp.asarray(x)))
    (pt,), _ = hmp.params_from_numpy([p], np.zeros((1, 32)))
    return pt, torch.from_numpy(x), ref


@pytest.mark.parametrize("double_buffer", [False, True])
@pytest.mark.parametrize("transport", ["padded", "bucketed"])
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("backend", ["eager", "kernel"])
@pytest.mark.parametrize("s", [16, 13])
def test_uneven_layer_matches_reference(s, backend, overlap, transport,
                                        double_buffer):
    pt, x, ref = _layer_case(s)
    plan = PLAN.with_backend(backend).with_transport(
        transport, double_buffer=double_buffer)
    lay = plan.seq_layout(s)
    y = hmp.hmp_layer(pt, lay.scatter(x), RING, plan=plan, overlap=overlap, seq=s)
    np.testing.assert_allclose(lay.gather(y).numpy(), ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("backend", ["eager", "kernel"])
@pytest.mark.parametrize("s", [16, 13])
def test_transport_modes_are_bitwise_equal(s, backend):
    """Padded vs bucketed transport, single vs double buffered: the same
    dataflow and summation order, so bitwise-equal outputs (pad rows
    included)."""
    pt, x, _ = _layer_case(s)
    base = PLAN.with_backend(backend)
    xp = base.seq_layout(s).scatter(x)
    outs = [hmp.hmp_layer(pt, xp, RING, plan=base.with_transport(t, double_buffer=db),
                          overlap=True, seq=s)
            for t in ("padded", "bucketed") for db in (False, True)]
    for y in outs[1:]:
        assert torch.equal(y, outs[0])


def test_layer_rejects_unscattered_input():
    pt, x, _ = _layer_case(13)
    with pytest.raises(ValueError, match="padded ragged layout"):
        hmp.hmp_layer(pt, x, RING, plan=PLAN, seq=13)
    with pytest.raises(ValueError, match="ring has"):
        hmp.hmp_layer(pt, x, LocalRing(2), plan=PLAN, seq=13)


@functools.lru_cache(maxsize=None)
def _stack():
    layers = jhmp.init_stack_params(jax.random.PRNGKey(0), 3, 32, 16, 64)
    emb = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (50, 32))) * 0.5
    lt, et = hmp.params_from_numpy(layers, emb)

    @jax.jit
    def ref_logits(tokens):  # (1, L) right-padded; causal, so row i is exact
        y = jhmp.reference_stack(layers, jnp.asarray(emb)[tokens])
        return y @ emb.T

    return lt, et, ref_logits


def _check_paged_against_reference_stack(plan: ExecPlan):
    lt, et, ref_logits = _stack()
    page, width = 8, 4
    block_row = np.arange(1, 1 + width)
    pages = hmp.make_kv_cache(1 + width, page, 3, plan)
    layers = [hmp.shard_layer_params(plan, p) for p in lt]
    toks = [3, 14, 15, 9, 26, 5, 35, 8, 9, 7, 9, 32, 38]
    s = len(toks)
    lay = plan.seq_layout(s)
    x = et[lay.scatter(torch.tensor([toks]))]
    y, pages = hmp.hmp_prefill(layers, x, RING, pages, plan=plan, seq=s,
                               block_row=block_row, overlap=True)
    logits = (lay.gather(y)[:, -1] @ et.T).numpy()

    padded = np.zeros((1, 24), np.int32)
    for step, nxt in enumerate([41, 2, 17]):
        padded[0, :len(toks)] = toks
        ref = np.asarray(ref_logits(padded))[0, len(toks) - 1]
        np.testing.assert_allclose(logits[0], ref, atol=1e-4, rtol=0)
        toks.append(nxt)
        x = et[torch.tensor([[nxt], [0]])]
        bt = np.stack([block_row, np.zeros(width, int)])
        y, pages = hmp.hmp_decode(layers, x, RING, pages,
                                  np.array([len(toks) - 1, 0]), plan=plan,
                                  block_table=bt)
        logits = (y[:, -1] @ et.T).numpy()
    padded[0, :len(toks)] = toks
    ref = np.asarray(ref_logits(padded))[0, len(toks) - 1]
    np.testing.assert_allclose(logits[0], ref, atol=1e-4, rtol=0)
    # pad head slots of every page stay exactly zero (the null-page routing
    # of the uneven-head gather relies on it)
    for c in pages:
        for i, h in enumerate(plan.heads):
            assert not c["k"][i][:, :, h:].any() and not c["v"][i][:, :, h:].any()


@pytest.mark.parametrize("backend", ["eager", "kernel"])
def test_paged_prefill_then_decode_matches_reference_stack(backend):
    """A 3-layer paged prefill of a ragged 13-token prompt, then paged decode
    steps of a 2-slot batch (slot 1 idle on the null page), give the
    logits of the reference stack over the full context."""
    _check_paged_against_reference_stack(PLAN.with_backend(backend))


@pytest.mark.parametrize("backend", ["eager", "kernel"])
def test_paged_decode_even_heads_matches_reference_stack(backend):
    """The same on an even split (4 heads and 16 columns per device, equal
    sequence shares): decode's valid-head gather reads every head slot."""
    even = ExecPlan(heads=(4, 4, 4, 4), columns=(16, 16, 16, 16), head_dim=2,
                    d_model=32, seq_shares=(1.0, 1.0, 1.0, 1.0))
    _check_paged_against_reference_stack(even.with_backend(backend))
