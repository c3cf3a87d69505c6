"""The port's planner, sequence layout and ring schedules reproduce the
reference's exactly (same integer arithmetic in numpy, so equality is
exact, not within a tolerance)."""
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread, so the xdist workers beside it keep their cores
torch.set_num_threads(1)

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402

from repro.configs.paper_models import PAPER_MODELS as J_MODELS  # noqa: E402
from repro.core import costmodel as jcost  # noqa: E402
from repro.core.execplan import ExecPlan as JExecPlan  # noqa: E402
from repro.core.profiler import AnalyticProfiler as JProfiler  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import costmodel  # noqa: E402
from repro_torch.core.execplan import REFERENCE_BACKENDS, ExecPlan  # noqa: E402
from repro_torch.core.profiler import AnalyticProfiler  # noqa: E402
from repro_torch.launch.serve import build_plan, cluster  # noqa: E402

ENVS = "ABCDEF"
GPT2_CAPS = (3, 2, 2, 1)


def _same_plan(a, b):
    assert a.feasible == b.feasible and a.reason == b.reason
    np.testing.assert_array_equal(a.mha, b.mha)
    np.testing.assert_array_equal(a.mlp, b.mlp)
    np.testing.assert_array_equal(a.seq, b.seq)


def _jax_devices(devs):
    return [jcost.DeviceSpec(d.name, d.flops, d.mem_bw, d.memory_budget)
            for d in devs]


@pytest.mark.parametrize("links", [None, 1000, 100])
@pytest.mark.parametrize("env", list(ENVS))
@pytest.mark.parametrize("model", ["distilbert", "gpt2-l"])
def test_plan_matches_reference_on_edge_envs(model, env, links):
    """The paper's Table III clusters (the reference's ``edge_env``)."""
    jdevs = jcost.edge_env(env)
    devs = [costmodel.DeviceSpec(d.name, d.flops, d.mem_bw, d.memory_budget)
            for d in jdevs]
    port = AnalyticProfiler(get_config(model), 256).plan(
        devs, links=None if links is None else [costmodel.mbps(links)] * len(devs))
    ref = JProfiler(J_MODELS[model], 256).plan(
        jdevs, links=None if links is None else [jcost.mbps(links)] * len(devs))
    _same_plan(port, ref)


@pytest.mark.parametrize("pad_penalty", [0.0, 0.5])
def test_gpt2l_uneven_cluster_plan(pad_penalty):
    """The slice's plan: heads [8,5,5,2], columns [1920,1280,1280,640],
    seq shares 28/28/28/16 on the 3:2:2:1 cluster — as the reference."""
    devs, links = cluster(GPT2_CAPS)
    port = AnalyticProfiler(get_config("gpt2-l"), 256).plan(
        devs, links=links, pad_penalty=pad_penalty)
    ref = JProfiler(J_MODELS["gpt2-l"], 256).plan(
        _jax_devices(devs), links=[jcost.mbps(1000)] * 4,
        pad_penalty=pad_penalty)
    _same_plan(port, ref)
    if pad_penalty == 0.0:
        ep = build_plan(get_config("gpt2-l"), GPT2_CAPS)
        assert ep.heads == (8, 5, 5, 2) and ep.pad_heads == 8
        assert ep.columns == (1920, 1280, 1280, 640) and ep.pad_columns == 1920
        # 72/72/72/40 of the planner's 256 rows
        np.testing.assert_array_equal(ep.seq_fractions,
                                      np.array([72, 72, 72, 40]) / 256)
        assert ep.seq_grain == 4
        lay = ep.seq_layout(200)
        assert lay.tiles == (57, 56, 56, 31) and lay.padded_len == 228


def _plans():
    gpt = build_plan(get_config("gpt2-l"), GPT2_CAPS)
    small = ExecPlan(heads=(6, 4, 4, 2), columns=(24, 16, 16, 8), head_dim=2,
                     d_model=32, seq_shares=(3.0, 2.0, 2.0, 1.0))
    return {"gpt2-l": gpt, "3:2:2:1": small}


def _reference_plan(ep: ExecPlan, transport="padded", double_buffer=False):
    backend = {v: k for k, v in REFERENCE_BACKENDS.items()}[ep.compute_backend]
    return JExecPlan(heads=ep.heads, columns=ep.columns, head_dim=ep.head_dim,
                     d_model=ep.d_model, seq_shares=ep.seq_shares,
                     compute_backend=backend, transport=transport,
                     double_buffer=double_buffer)


@pytest.mark.parametrize("seq", [13, 16, 37, 200])
@pytest.mark.parametrize("plan", ["gpt2-l", "3:2:2:1"])
def test_seq_layout_matches_reference(plan, seq):
    ep = _plans()[plan]
    a, b = ep.seq_layout(seq), _reference_plan(ep).seq_layout(seq)
    assert a.tiles == b.tiles and a.padded_len == b.padded_len
    np.testing.assert_array_equal(a.rows, b.rows)
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(a.attention_mask(), b.attention_mask())


@pytest.mark.parametrize("double_buffer", [False, True])
@pytest.mark.parametrize("transport", ["padded", "bucketed"])
@pytest.mark.parametrize("seq", [13, 37, 200])
def test_ring_schedule_matches_reference(seq, transport, double_buffer):
    for ep in _plans().values():
        port = ep.with_transport(transport, double_buffer=double_buffer)
        a = port.ring_schedule(seq)
        b = _reference_plan(ep, transport, double_buffer).ring_schedule(seq)
        assert [dataclasses.astuple(t) for t in a.tiles] == \
            [dataclasses.astuple(t) for t in b.tiles]
        assert (a.pad_tile, a.transport, a.double_buffer) == \
            (b.pad_tile, b.transport, b.double_buffer)
        np.testing.assert_array_equal(a.valid_sizes, b.valid_sizes)
        np.testing.assert_array_equal(a.buckets, b.buckets)
        assert a.segment_bounds == b.segment_bounds
        assert (a.is_masked, a.is_bucketed) == (b.is_masked, b.is_bucketed)
        for hop in range(a.num_devices):
            np.testing.assert_array_equal(a.hop_rows(hop), b.hop_rows(hop))
            assert a.buffer_slot(hop) == b.buffer_slot(hop)
        assert a.total_wire_rows() == b.total_wire_rows()
        assert a.wire_fraction() == b.wire_fraction()


def test_pad_layer_params_matches_reference():
    import jax

    from repro.core import hmp as jhmp
    from repro_torch.core import hmp

    ep = _plans()["3:2:2:1"]
    p = jhmp.init_layer_params(jax.random.PRNGKey(0), 32, 16, 64)
    ref = _reference_plan(ep).pad_layer_params(p)
    (pt,), _ = hmp.params_from_numpy([p], np.zeros((1, 32)))
    port = ep.pad_layer_params(pt)
    for name in ref:
        np.testing.assert_array_equal(port[name].numpy(), np.asarray(ref[name]))
