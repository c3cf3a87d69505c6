"""The port's cost model, Eq. 4/5 objective, ExecPlan scoring hooks and
edge-cluster simulator (``core/costmodel.py``, ``core/planner.py``,
``core/execplan.py``, ``core/simulator.py``) against the reference's on
the same inputs: every scenario and metric of
``tests/golden/sim_latency.json`` built as ``tests/test_sim_regression.py``
builds it, the five schedules on the paper's models and edge
environments, speculative pricing, the drift monitor's step pricer, and
the calibration hook.  All numpy: equal to 1e-9 relative.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import costmodel as jcost  # noqa: E402
from repro.core import planner as jplanner  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core.execplan import ExecPlan as JExecPlan  # noqa: E402
from repro.core.profiler import AnalyticProfiler as JProfiler  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import costmodel, planner, simulator  # noqa: E402
from repro_torch.core.execplan import REFERENCE_BACKENDS, ExecPlan  # noqa: E402
from repro_torch.core.profiler import AnalyticProfiler, HostProfiler  # noqa: E402
from test_sim_regression import _golden  # noqa: E402
from test_sim_regression import _score as j_score  # noqa: E402
from test_sim_regression import scenarios as j_scenarios  # noqa: E402

RTOL = 1e-9
PAPER_MODELS = ("distilbert", "bert-l", "gpt2-l", "opt-l", "opt-xl")
ENVS = "ABCDEF"
SCHEDULES = ("local", "megatron", "sp", "galaxy", "galaxy_overlap")


def same(a, b) -> bool:
    """Equal to RTOL relative, inf (OOM) equal to inf, None to None."""
    if a is None or b is None:
        return a is None and b is None
    a, b = float(a), float(b)
    if math.isinf(a) or math.isinf(b):
        return a == b
    return abs(a - b) <= RTOL * max(abs(a), abs(b), 1e-300)


def same_array(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a, float), np.asarray(b, float)
    return a.shape == b.shape and all(same(x, y) for x, y in zip(a.ravel(), b.ravel()))


# --- carrying reference objects across ------------------------------------------

def port_plan(jp: JExecPlan) -> ExecPlan:
    return ExecPlan(heads=jp.heads, columns=jp.columns, head_dim=jp.head_dim,
                    d_model=jp.d_model, seq_shares=jp.seq_shares,
                    compute_backend=REFERENCE_BACKENDS[jp.compute_backend],
                    transport=jp.transport, double_buffer=jp.double_buffer)


def port_cfg(jcfg):
    return dataclasses.replace(get_config(jcfg.name), num_layers=jcfg.num_layers)


def port_devices(jdevs):
    return [costmodel.DeviceSpec(d.name, d.flops, d.mem_bw, d.memory_budget) for d in jdevs]


def port_link(jlink):
    if isinstance(jlink, jcost.LinkSpec):
        return costmodel.LinkSpec(jlink.bandwidth, jlink.latency)
    return [port_link(x) for x in jlink]


def port_score(ep, cfg, devices, link, seq):
    """``test_sim_regression._score`` on the port (its "pallas" backend is
    the port's "kernel")."""
    sim = simulator.simulate_execplan
    return {
        "sync_us": sim(ep, cfg, devices, link, seq, overlap=False).latency * 1e6,
        "overlap_us": sim(ep, cfg, devices, link, seq, overlap=True).latency * 1e6,
        "padded_us": sim(ep, cfg, devices, link, seq, overlap=True,
                         padded=True).latency * 1e6,
        "padshed_us": sim(ep.with_backend("kernel"), cfg, devices, link, seq,
                          overlap=True, padded=True).latency * 1e6,
        "bucketed_overlap_us": sim(ep.with_transport("bucketed", double_buffer=True),
                                   cfg, devices, link, seq, overlap=True,
                                   padded=True).latency * 1e6,
        "prefix_hit_us": sim(ep, cfg, devices, link, seq, overlap=True,
                             cached_prefix=seq // 2).latency * 1e6,
        "spec_decode_us": simulator.spec_decode_summary(
            ep, cfg, devices, link, draft_cfg=cfg, k=4, acceptance=0.8,
            context_len=seq)["time_per_token_spec"] * 1e6,
    }


SCENARIOS = {row[0]: row for row in j_scenarios()}
METRICS = sorted(next(iter(_golden().values())))


@pytest.fixture(scope="module")
def scored():
    """Each golden scenario scored by both packages; the port builds its
    own plans with its own planner from the same cluster."""
    out = {}
    for name, (_, jep, jcfg, jdevs, jlink, seq) in SCENARIOS.items():
        cfg, devs, link = port_cfg(jcfg), port_devices(jdevs), port_link(jlink)
        if name == "distilbert_4dev_even":
            ep = ExecPlan.even(4, num_heads=cfg.num_heads, d_ff=cfg.d_ff,
                               head_dim=cfg.head_dim, d_model=cfg.d_model)
        else:
            prof = AnalyticProfiler(cfg, seq)
            pl = (prof.plan(devs, links=link) if name.endswith("raggedsp")
                  else planner.plan(prof.model_profile(), prof.device_profiles(devs)))
            ep = ExecPlan.from_plan(pl, head_dim=cfg.head_dim, d_model=cfg.d_model)
        out[name] = (ep, jep, j_score(jep, jcfg, jdevs, jlink, seq),
                     port_score(ep, cfg, devs, link, seq))
    return out


def test_golden_scenarios_cover_the_golden_file():
    assert set(SCENARIOS) == set(_golden())
    assert all(set(row) == set(METRICS) for row in _golden().values())


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_golden_scenario_metric_matches_reference(scored, name, metric):
    ep, jep, want, got = scored[name]
    assert (ep.heads, ep.columns) == (jep.heads, jep.columns)
    assert np.allclose(ep.seq_fractions, jep.seq_fractions, rtol=RTOL, atol=0)
    assert same(got[metric], want[metric]), (name, metric, got[metric], want[metric])
    # and the reference's own regression band around the checked-in value
    golden = _golden()[name][metric]
    assert abs(got[metric] - golden) <= 0.20 * golden


# --- the five schedules on the paper's models and environments --------------------

@pytest.mark.parametrize("env", ENVS)
@pytest.mark.parametrize("model", PAPER_MODELS)
def test_simulate_schedules_match_reference(model, env):
    jcfg, cfg = j_get_config(model), get_config(model)
    jdevs, devs = jcost.edge_env(env), costmodel.edge_env(env)
    assert devs == port_devices(jdevs)
    for mb in (125, 1000):
        for seq in (30, 284):
            for sched in SCHEDULES:
                want = jsim.simulate(jcfg, jdevs, jcost.mbps(mb), seq, sched)
                got = simulator.simulate(cfg, devs, costmodel.mbps(mb), seq, sched)
                what = (model, env, mb, seq, sched)
                assert same(got.latency, want.latency), what
                assert got.oom == want.oom, what
                assert same_array(got.per_device_mem, want.per_device_mem), what
                assert (got.breakdown is None) == (want.breakdown is None), what
                if want.breakdown is not None:
                    assert set(got.breakdown) == set(want.breakdown), what
                    assert all(same(got.breakdown[k], v)
                               for k, v in want.breakdown.items()), what


@pytest.mark.parametrize("model", PAPER_MODELS)
def test_speedup_table_and_scaling_match_reference(model):
    jcfg, cfg = j_get_config(model), get_config(model)
    for env in ENVS:
        want = jsim.speedup_table(jcfg, jcost.edge_env(env), jcost.mbps(125), 284)
        got = simulator.speedup_table(cfg, costmodel.edge_env(env), costmodel.mbps(125), 284)
        assert set(got) == set(want)
        for k, v in want.items():
            assert (got[k] == v) if isinstance(v, str) else same(got[k], v), (env, k)
    gpu = simulator.speedup_table(cfg, [costmodel.jetson_nano_gpu(6.0)] * 2,
                                  costmodel.mbps(500), 284)
    jgpu = jsim.speedup_table(jcfg, [jcost.jetson_nano_gpu(6.0)] * 2, jcost.mbps(500), 284)
    assert all((gpu[k] == v) if isinstance(v, str) else same(gpu[k], v)
               for k, v in jgpu.items())
    dev, jdev = costmodel.jetson_nano("nano-m", 1.5), jcost.jetson_nano("nano-m", 1.5)
    for got, want in (
            (simulator.weak_scaling(cfg, dev, costmodel.mbps(1000), 96),
             jsim.weak_scaling(jcfg, jdev, jcost.mbps(1000), 96)),
            (simulator.strong_scaling(cfg, dev, costmodel.mbps(1000), 384),
             jsim.strong_scaling(jcfg, jdev, jcost.mbps(1000), 384))):
        assert same_array(got, want)


def test_simulate_argument_errors_match_reference():
    cfg = get_config("distilbert")
    devs = costmodel.edge_env("C")
    ep = ExecPlan.even(4, num_heads=cfg.num_heads, d_ff=cfg.d_ff,
                       head_dim=cfg.head_dim, d_model=cfg.d_model)
    link = costmodel.mbps(1000)
    with pytest.raises(ValueError, match="plan= only applies"):
        simulator.simulate(cfg, devs, link, 64, "sp", plan=ep.to_planner_plan())
    with pytest.raises(ValueError, match="context_len= only applies"):
        simulator.simulate(cfg, devs, link, 64, "local", context_len=64)
    with pytest.raises(ValueError, match="must cover"):
        simulator.simulate(cfg, devs, link, 64, "galaxy", context_len=32)
    with pytest.raises(ValueError, match="plan covers"):
        simulator.simulate_execplan(ep, cfg, devs[:2], link, 64)
    with pytest.raises(ValueError, match="cached_prefix"):
        simulator.simulate_execplan(ep, cfg, devs, link, 64, cached_prefix=64)
    with pytest.raises(ValueError):
        simulator.simulate(cfg, devs, link, 64, "bogus")


# --- speculative pricing and the drift monitor's step pricer -------------------------

def _uneven(model="gpt2-l"):
    """Alg. 1's plan for a 3:2:2:1 cluster, in both packages."""
    jcfg, cfg = j_get_config(model), get_config(model)
    jdevs = [jcost.DeviceSpec(f"edge{i}", c * 7.1e9, c * 4e9, 4e9)
             for i, c in enumerate((3, 2, 2, 1))]
    devs = port_devices(jdevs)
    links = [costmodel.mbps(1000)] * 4
    ep = ExecPlan.from_plan(AnalyticProfiler(cfg, 256).plan(devs, links=links),
                            head_dim=cfg.head_dim, d_model=cfg.d_model)
    jep = JExecPlan(ep.heads, ep.columns, ep.head_dim, ep.d_model, ep.seq_shares)
    return (jep, jcfg, jdevs, jcost.mbps(1000)), (ep, cfg, devs, costmodel.mbps(1000))


@pytest.mark.parametrize("acceptance", [0.0, 0.4, 0.8, 1.0])
def test_spec_decode_summary_and_choose_k_match_reference(acceptance):
    (jep, jcfg, jdevs, jlink), (ep, cfg, devs, link) = _uneven()
    jdraft, draft = j_get_config("distilbert"), get_config("distilbert")
    for k in (1, 2, 4, 8):
        for context in (16, 300):
            want = jsim.spec_decode_summary(jep, jcfg, jdevs, jlink, draft_cfg=jdraft, k=k,
                                            acceptance=acceptance, context_len=context)
            got = simulator.spec_decode_summary(ep, cfg, devs, link, draft_cfg=draft, k=k,
                                                acceptance=acceptance, context_len=context)
            assert set(got) == set(want)
            assert all(same(got[key], v) for key, v in want.items()), (k, context)
    for context in (3, 12, 300):
        want = jsim.choose_spec_k(jep, jcfg, jdevs, jlink, draft_cfg=jdraft,
                                  acceptance=acceptance, context_len=context)
        got = simulator.choose_spec_k(ep, cfg, devs, link, draft_cfg=draft,
                                      acceptance=acceptance, context_len=context)
        assert all(same(got[key], v) for key, v in want.items()), context
    with pytest.raises(ValueError, match="must exceed"):
        simulator.spec_decode_summary(ep, cfg, devs, link, draft_cfg=draft, k=4,
                                      acceptance=acceptance, context_len=5)
    with pytest.raises(ValueError, match="no room"):
        simulator.choose_spec_k(ep, cfg, devs, link, draft_cfg=draft,
                                acceptance=acceptance, context_len=2)


@pytest.mark.parametrize("with_draft", [False, True])
@pytest.mark.parametrize("overlap", [False, True])
def test_step_pricer_matches_reference_over_grid(with_draft, overlap):
    (jep, jcfg, jdevs, jlink), (ep, cfg, devs, link) = _uneven()
    jdraft = j_get_config("distilbert") if with_draft else None
    draft = get_config("distilbert") if with_draft else None
    want = jsim.make_step_pricer(jep, jcfg, jdevs, jlink, draft_cfg=jdraft, overlap=overlap)
    got = simulator.make_step_pricer(ep, cfg, devs, link, draft_cfg=draft, overlap=overlap)
    n_none = 0
    for kind in ("decode", "prefill_chunk", "spec_verify", "draft"):
        for rows in (0, 1, 5, 128):
            for context in (0, 1, 4, 37, 256, 556):
                w = want(kind, rows=rows, context=context)
                assert same(got(kind, rows=rows, context=context), w), (kind, rows, context)
                assert same(got(kind, rows=rows, context=context), w)  # memoized
                n_none += w is None
    assert n_none > 0
    if not with_draft:
        assert got("draft", rows=3, context=8) is None
    assert got("decode", rows=1, context=32) == simulator.simulate_execplan(
        ep, cfg, devs, link, 32, overlap=overlap, cached_prefix=31).latency
    with pytest.raises(ValueError, match="devices"):
        simulator.make_step_pricer(ep, cfg, devs[:1], link)


# --- cost model, objective and ExecPlan hooks ------------------------------------------

def test_costmodel_matches_reference():
    for kind in ("nano-l", "nano-m", "nano-s"):
        for gb in (0.7, 1.5, 4.0):
            assert costmodel.jetson_nano(kind, gb) == port_devices(
                [jcost.jetson_nano(kind, gb)])[0]
    assert costmodel.jetson_nano_gpu() == port_devices([jcost.jetson_nano_gpu()])[0]
    for env in ENVS:
        assert costmodel.edge_env(env) == port_devices(jcost.edge_env(env))
    links = [costmodel.mbps(m) for m in (1000, 100, 500)]
    jlinks = [jcost.mbps(m) for m in (1000, 100, 500)]
    assert costmodel.bottleneck_link(links, 3) == port_link(jcost.bottleneck_link(jlinks, 3))
    assert costmodel.bottleneck_link(links[0], 3) == links[0]
    for n_bytes in (0.0, 1e3, 7.5e6):
        for d in (1, 2, 3, 8):
            for f, jf in ((costmodel.t_allgather, jcost.t_allgather),
                          (costmodel.t_reducescatter, jcost.t_reducescatter),
                          (costmodel.t_allreduce, jcost.t_allreduce)):
                assert same(f(n_bytes, d, links[1]), jf(n_bytes, d, jlinks[1]))
    for d_model, hd in ((768, 64), (1280, 64), (5120, 160)):
        assert costmodel.gemm_unit_flops(d_model, hd) == jcost.gemm_unit_flops(d_model, hd)
    for model in PAPER_MODELS + ("qwen1.5-0.5b", "stablelm-12b"):
        assert same(costmodel.model_memory_bytes(get_config(model)),
                    jcost.model_memory_bytes(j_get_config(model)))


def test_plan_latency_matches_reference():
    for model in ("bert-l", "gpt2-l"):
        for env in ENVS:
            cfg, jcfg = get_config(model), j_get_config(model)
            prof, jprof = AnalyticProfiler(cfg, 284), JProfiler(jcfg, 284)
            devs = prof.device_profiles(costmodel.edge_env(env))
            jdevs = jprof.device_profiles(jcost.edge_env(env))
            pl = planner.plan(prof.model_profile(), devs)
            jpl = jplanner.plan(jprof.model_profile(), jdevs)
            p = prof.prof
            args = (p["mha_flops"], p["mlp_flops"], p["con_bytes"] / 4e9)
            assert same(planner.plan_latency(pl, prof.model_profile(), devs, *args),
                        jplanner.plan_latency(jpl, jprof.model_profile(), jdevs, *args))
    for units, total, flops, cap in ((3, 20, 1e9, 2.0), (0, 16, 5e8, 1.0), (7, 7, 1.0, 0.5)):
        assert same(planner.block_latency(units, total, flops, cap),
                    jplanner.block_latency(units, total, flops, cap))


PLANS = [
    dict(heads=(6, 4, 4, 2), columns=(24, 16, 16, 8), head_dim=2, d_model=32,
         seq_shares=(3.0, 2.0, 2.0, 1.0)),
    dict(heads=(8, 5, 5, 2), columns=(1920, 1280, 1280, 640), head_dim=64, d_model=1280,
         seq_shares=(72.0, 72.0, 72.0, 40.0)),
    dict(heads=(3, 3), columns=(8, 8), head_dim=4, d_model=12),
    dict(heads=(5, 0, 3), columns=(7, 9, 0), head_dim=8, d_model=16,
         seq_shares=(1.0, 0.0, 2.0)),
]


@pytest.mark.parametrize("transport", ["padded", "bucketed"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("kw", PLANS, ids=lambda kw: "x".join(map(str, kw["heads"])))
def test_execplan_scoring_hooks_match_reference(kw, backend, transport):
    jep = JExecPlan(**kw, compute_backend=backend, transport=transport)
    ep = port_plan(jep)
    assert (ep.is_even, ep.uneven_seq) == (jep.is_even, jep.uneven_seq)
    for padded in (False, True):
        for a, b in zip(ep.compute_fractions(padded), jep.compute_fractions(padded)):
            assert same_array(a, b)
        pl, jpl = ep.to_planner_plan(padded), jep.to_planner_plan(padded)
        assert np.array_equal(pl.mha, jpl.mha) and np.array_equal(pl.mlp, jpl.mlp)
        assert same_array(pl.seq, jpl.seq) and same_array(pl.seq_wire, jpl.seq_wire)
        assert pl.feasible and jpl.feasible
        for seq in (1, 17, 256):
            assert same_array(ep.device_gemm_flops(seq, padded),
                              jep.device_gemm_flops(seq, padded))
            assert same_array(ep.prefill_gemm_flops(seq + 5, cached_prefix=seq // 2,
                                                    padded=padded),
                              jep.prefill_gemm_flops(seq + 5, cached_prefix=seq // 2,
                                                     padded=padded))
    with pytest.raises(ValueError, match="cached_prefix"):
        ep.prefill_gemm_flops(8, cached_prefix=8)
    assert same(ep.flops_shed(), jep.flops_shed())
    assert same(ep.padding_waste(), jep.padding_waste())
    assert same(ep.seq_padding_waste(), jep.seq_padding_waste())
    assert same_array(ep.wire_fractions(), jep.wire_fractions())
    assert np.array_equal(ep.head_mask(), jep.head_mask())
    assert np.array_equal(ep.column_mask(), jep.column_mask())
    for page, nbytes in ((8, 4), (16, 2)):
        assert ep.kv_page_bytes(page, nbytes) == jep.kv_page_bytes(page, nbytes)
    for seq in (1, 5, 37, 300):
        assert ep.seq_tile(seq) == jep.seq_tile(seq)
        assert ep.padded_seq(seq) == jep.padded_seq(seq)
        lay, jlay = ep.seq_layout(seq), jep.seq_layout(seq)
        assert np.array_equal(lay.offsets, jlay.offsets)
        assert same(lay.padding_waste(), jlay.padding_waste())


# --- calibration ------------------------------------------------------------------------

def test_apply_calibration_refuses_atomically_and_restores():
    before = (costmodel.GFLOPS_PER_GHZ, costmodel.BYTES_ACT, simulator.TILE_OVERHEAD)
    with pytest.raises(ValueError, match="not calibratable"):
        costmodel.apply_calibration({"GFLOPS_PER_GHZ": 1.0, "NOT_A_CONSTANT": 2.0})
    assert (costmodel.GFLOPS_PER_GHZ, costmodel.BYTES_ACT,
            simulator.TILE_OVERHEAD) == before  # nothing was touched
    cfg, jcfg = get_config("bert-l"), j_get_config("bert-l")
    over = {"GFLOPS_PER_GHZ": 11.0e9, "NANO_MEM_BW": 3.0e9, "BYTES_ACT": 2.0,
            "TILE_OVERHEAD": 0.11}
    prev = costmodel.apply_calibration(over)
    jprev = jcost.apply_calibration(over)
    try:
        assert prev == {"GFLOPS_PER_GHZ": before[0], "NANO_MEM_BW": 4.0e9,
                        "BYTES_ACT": before[1], "TILE_OVERHEAD": before[2]}
        assert simulator.TILE_OVERHEAD == 0.11 and costmodel.BYTES_ACT == 2.0
        for sched in SCHEDULES:
            got = simulator.simulate(cfg, costmodel.edge_env("F"), costmodel.mbps(125),
                                     284, sched).latency
            want = jsim.simulate(jcfg, jcost.edge_env("F"), jcost.mbps(125), 284,
                                 sched).latency
            assert same(got, want), sched
    finally:
        costmodel.apply_calibration(prev)
        jcost.apply_calibration(jprev)
    assert (costmodel.GFLOPS_PER_GHZ, costmodel.BYTES_ACT,
            simulator.TILE_OVERHEAD) == before
    assert costmodel.NANO_MEM_BW == 4.0e9


# --- HostProfiler (the card's own timing runs in tests/test_torch_cuda.py) --------------

def test_host_profiler_times_plain_blocks_on_the_cpu():
    cfg = dataclasses.replace(get_config("distilbert"), num_layers=1)
    hp = HostProfiler(cfg, 8, iters=2, device="cpu")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        t = hp.measure_blocks(heads=2, columns=64)
        assert torch.backends.cuda.matmul.allow_tf32 is True  # restored after timing
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert set(t) == {"mha", "mlp", "con"} and all(v > 0 for v in t.values())
    assert hp.capacity() > 0
