"""The port's experiments and examples against the reference's: the
coordinate hillclimb and the cost-model calibration (as
``tests/test_calibrate.py`` tests the reference's), the simulated side of
the calibration equal to the reference's, the measured side on the CPU,
the dry-run hillclimbs at a cut depth, and each example's ``main`` on the
CPU at reduced size.

Tolerances: the simulated layer times within 1e-9 relative of the
reference's (both are the same numpy cost model); the fit as the
reference's test asks (loss below 0.05 and every residual ratio within
e^0.25 after 6 rounds).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import io  # noqa: E402
import json  # noqa: E402
from contextlib import redirect_stdout  # noqa: E402

import numpy as np  # noqa: E402

from experiments.calibrate import DEFAULT_CONSTANTS as J_DEFAULT_CONSTANTS  # noqa: E402
from experiments.calibrate import simulated as j_simulated  # noqa: E402
from repro.core.simulator import simulate_execplan as j_simulate_execplan  # noqa: E402
from repro_torch.experiments import calibrate, hillclimb  # noqa: E402
from repro_torch.roofline import report  # noqa: E402


def _quiet(fn, *args, **kwargs):
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue()


# --- the hillclimb and the calibration ------------------------------------------

def test_coordinate_hillclimb_minimizes_quadratic():
    best, loss = hillclimb.coordinate_hillclimb(
        lambda p: (p["a"] - 4.0) ** 2 + (p["b"] - 0.25) ** 2, {"a": 1.0, "b": 1.0})
    assert loss < 0.05
    assert abs(best["a"] - 4.0) < 0.5 and abs(best["b"] - 0.25) < 0.1


@pytest.mark.parametrize("backend", ["eager", "kernel"])
def test_calibrate_reduces_residuals(backend):
    """Measurements synthesized from a "true" host 2x slower than the
    starting guess with a 4x slower ring: the fit closes the gap, for the
    reference's scenario and for GPT2-L's served plan together."""
    true = dict(calibrate.DEFAULT_CONSTANTS)
    true["host_flops"] /= 2
    true["link_bw"] /= 4
    measured = calibrate.simulated(true, backend=backend, scenarios=list(calibrate.SCENARIOS))
    assert set(measured) == {"hmp", "hmp_ring", "gpt2-l/hmp", "gpt2-l/hmp_ring"}
    assert all(v > 0 for v in measured.values())
    rep = calibrate.calibrate(measured=measured, rounds=6, backend=backend)
    assert rep["loss"] < rep["start_loss"]
    assert rep["loss"] < 0.05
    ratios = np.array(list(rep["residual_ratio"].values()))
    assert np.all(np.abs(np.log(ratios)) < 0.25), rep["residual_ratio"]
    assert "not a wire" in calibrate.summary(rep)


def test_calibrate_fits_the_cards_layers_scenario_by_scenario():
    """Layer times an H100 gave (80GB HBM3, 700 W; the smoke's calibrate
    phase): each scenario's own fit within e^0.25.  Their ring/sync ratios
    of 3.0 and 1.5 need ``host_flops`` and ``tile_overhead`` to move
    together, which the reference's coarse moves alone could not."""
    measured = {"hmp": 1.6586e-3, "hmp_ring": 4.9364e-3,
                "gpt2-l/hmp": 3.3891e-3, "gpt2-l/hmp_ring": 5.2136e-3}
    reports = calibrate.calibrate_scenarios(measured, rounds=calibrate.ROUNDS,
                                            backend="kernel")
    for fit in ("distilbert", "gpt2-l"):
        ratios = np.array(list(reports[fit]["residual_ratio"].values()))
        assert np.all(np.abs(np.log(ratios)) < 0.25), (fit, reports[fit]["residual_ratio"])
    # both at once the cost model cannot: it prices the ring by compute
    assert reports["joint"]["loss"] > 0.25


@pytest.mark.parametrize("constants", ["reference", "port"])
def test_simulated_equals_reference(constants):
    c = dict(J_DEFAULT_CONSTANTS if constants == "reference" else calibrate.DEFAULT_CONSTANTS)
    want = j_simulated(c)
    got = calibrate.simulated(c)
    assert set(got) == set(want)
    for key in want:
        assert abs(got[key] - float(want[key])) <= 1e-9 * abs(float(want[key]))


def test_kernel_backend_is_simulated_unpadded():
    """The kernel backend sheds pad blocks: its layers are scored on the
    plan's assigned units (the reference's ``padded=False``).  On the
    host's four equal devices that score equals the padded one: the
    slowest device holds the most units either way."""
    from repro.configs import get_config as j_get_config
    from repro.core.execplan import ExecPlan as JExecPlan
    import dataclasses

    c = calibrate.DEFAULT_CONSTANTS
    got = calibrate.simulated(c, backend="kernel")
    cfg, eplan, seq = calibrate._plan_and_cfg("distilbert")
    jcfg = dataclasses.replace(j_get_config("distilbert"), num_layers=1)
    jplan = JExecPlan(heads=eplan.heads, columns=eplan.columns, head_dim=eplan.head_dim,
                      d_model=eplan.d_model, seq_shares=eplan.seq_shares)
    from repro.core import costmodel as jcm

    devices = [jcm.DeviceSpec(f"host{i}", flops=c["host_flops"], mem_bw=c["host_bw"],
                              memory_budget=1e12) for i in range(4)]
    link = jcm.LinkSpec(bandwidth=c["link_bw"], latency=c["link_lat"])
    prev = jcm.apply_calibration({"TILE_OVERHEAD": c["tile_overhead"]})
    try:
        want = j_simulate_execplan(jplan, jcfg, devices, link, seq, overlap=True,
                                   padded=False).latency
    finally:
        jcm.apply_calibration(prev)
    assert abs(got["hmp_ring"] - want) <= 1e-9 * want


def test_measure_on_cpu_gives_positive_times():
    m = calibrate.measure(device="cpu", backend="eager", iters=1)
    assert set(m) == {"hmp", "hmp_ring"} and all(v > 0 for v in m.values())
    rep = calibrate.calibrate(measured=m, rounds=1)
    assert rep["measured_s"] == m and rep["loss"] <= rep["start_loss"]


def test_calibrate_main_writes_the_report(tmp_path, monkeypatch):
    fake = {"hmp": 1e-3, "hmp_ring": 2e-3}
    monkeypatch.setattr(calibrate, "measure", lambda **kw: dict(fake))
    out = tmp_path / "calibration.json"
    rc, text = _quiet(calibrate.main, ["--device", "cpu", "--out", str(out)])
    assert rc == 0 and "not a wire" in text
    rep = json.loads(out.read_text())["distilbert"]
    assert rep["measured_s"] == fake and rep["loss"] <= rep["start_loss"]


def test_calibrate_scenarios_fits_each_alone_and_all_together():
    true = dict(calibrate.DEFAULT_CONSTANTS, host_flops=3e11, tile_overhead=0.4)
    measured = calibrate.simulated(true, backend="kernel", scenarios=list(calibrate.SCENARIOS))
    reports = calibrate.calibrate_scenarios(measured, rounds=6, backend="kernel")
    assert list(reports) == ["distilbert", "gpt2-l", "joint"]
    assert set(reports["gpt2-l"]["measured_s"]) == {"gpt2-l/hmp", "gpt2-l/hmp_ring"}
    assert reports["joint"]["measured_s"] == measured
    for rep in reports.values():
        assert rep["loss"] < rep["start_loss"]


# --- the dry-run hillclimbs --------------------------------------------------------

def test_hillclimb_runs_mirror_the_reference():
    """The reference's six variants and the TP-only baseline, with its
    overrides; each chain starts from its plain pair."""
    tags = [r[2] for r in hillclimb.RUNS]
    assert tags == ["h1a_remat_dots", "h1b_cf125", "h1c_attnchunk", "h2a_weights_model_only",
                    "h2b_fp8_weights", "h3a_attnchunk", "tp_only"]
    bases = {r[2]: r[5] for r in hillclimb.RUNS}
    assert bases["h1c_attnchunk"] == "h1b_cf125" and bases["h3a_attnchunk"] == ""
    assert dict(hillclimb.RUNS[4][3]) == {"param_dtype": "float8_e4m3fn"}


@pytest.mark.parametrize("only", ["h3a", "h2"])
def test_hillclimb_variants_at_a_cut_depth(only, tmp_path, monkeypatch):
    """One layer of each pair: query-chunked attention lowers codeqwen's
    prefill peak a chip; fp8 weights halve qwen1.5-110b's argument bytes
    beside the same layout in bf16.  The records carry their tags, are
    saved under them, and the report tables each beside its baseline."""
    from repro_torch.launch import dryrun

    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    (records, failures), text = _quiet(hillclimb.run, only, num_layers=1)
    assert not failures, failures
    by_tag = {key[2]: r for key, r in records.items()}
    if only == "h3a":
        assert set(by_tag) == {"", "h3a_attnchunk"}
        base, var = by_tag[""], by_tag["h3a_attnchunk"]
        assert var["peak_mem_bytes_per_chip"] < base["peak_mem_bytes_per_chip"]
        assert var["hlo_flops_per_chip"] == base["hlo_flops_per_chip"]
    else:
        assert set(by_tag) == {"", "h2a_weights_model_only", "h2b_fp8_weights"}
        base, var = by_tag["h2a_weights_model_only"], by_tag["h2b_fp8_weights"]
        assert var["argument_bytes"] * 2 == base["argument_bytes"]
    rows = report.load("16x16", directory=tmp_path)
    table = report.variants_table(report.load_variants("16x16", directory=tmp_path), rows)
    assert var["variant"] in table and "? ->" not in table
    assert text.count("peak/chip") == len(by_tag)


def test_hillclimb_reports_a_failed_variant_and_goes_on(monkeypatch, tmp_path):
    from repro_torch.launch import dryrun

    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    calls = []

    def fake_run_one(arch, shape, **kw):
        calls.append(kw.get("variant"))
        if kw.get("variant") == "h1b_cf125":
            raise RuntimeError("boom")
        return {"t_compute_s": 1.0, "t_memory_s": 1.0, "t_collective_s": 1.0,
                "bottleneck": "memory", "useful_flops_ratio": 0.5, "roofline_mfu": 0.1,
                "temp_bytes": 0, "argument_bytes": 0, "hlo_flops_per_chip": 1.0,
                "peak_mem_bytes_per_chip": 0, "arch": arch, "shape": shape, "mesh": "16x16",
                "collective_bytes_per_chip": {}, "hlo_bytes_per_chip": 1.0,
                "roofline_step_s": 1.0}

    monkeypatch.setattr(dryrun, "run_one", fake_run_one)
    rc, text = _quiet(hillclimb.main, ["h1"])
    assert rc == 1 and "FAILED: RuntimeError: boom" in text
    assert calls == ["", "h1a_remat_dots", "h1b_cf125", "h1c_attnchunk"]
    # the records that ran are saved, each under its tag
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "granite-moe-3b-a800m__train_4k__16x16.json",
        "granite-moe-3b-a800m__train_4k__16x16__h1a_remat_dots.json",
        "granite-moe-3b-a800m__train_4k__16x16__h1c_attnchunk.json"]


def test_dry_runs_after_a_torn_down_group():
    """The hillclimb runs after other dry runs in one process.  Tearing
    down a fake group must empty ``DTensor``'s sharding caches, which hold
    the meshes (and group names) they were made on: a later mesh equal to
    an old one was handed the torn-down groups ("Could not resolve the
    process group", on the card after the smoke's dry-run phases; this
    sequence of one-layer runs failed the same way here)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import destroy_fake_group

    cut = {"num_layers": 1}
    try:
        for arch, shape in [("qwen1.5-0.5b", "decode_32k"), ("granite-moe-3b-a800m", "train_4k")]:
            dryrun.run_one(arch, shape, save=False, verbose=False, cfg_overrides=cut)
        destroy_fake_group()
        r = dryrun.run_one("granite-moe-3b-a800m", "train_4k", save=False, verbose=False,
                           cfg_overrides=cut)
    finally:
        destroy_fake_group()
    assert r["hlo_flops_per_chip"] > 0


# --- the examples --------------------------------------------------------------

def test_quickstart_example():
    from repro_torch.examples import quickstart

    out, text = _quiet(quickstart.main, ["--device", "cpu"])
    assert out["finite"] and out["logits_shape"][:2] == (2, 32)
    assert "Galaxy HMP logical->mesh mapping" in text


def test_plan_heterogeneous_example():
    from repro_torch.examples import plan_heterogeneous

    out, text = _quiet(plan_heterogeneous.main, [])
    assert set(out) == {"C", "D", "E", "F"} and "galaxy latency" in text


def test_train_small_example(tmp_path):
    from repro_torch.examples import train_small

    out, text = _quiet(train_small.main, ["--device", "cpu", "--steps", "2", "--ckpt",
                                          str(tmp_path / "ck")])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert "qwen1.5-0.5b-smoke: 2L d=512" in text


SERVE_DEMOS = ("serve", "hmp", "continuous_batching", "speculative_decoding", "galaxy_serving",
               "raggedsp_serving", "overlap_transport", "padshed_backend", "prefix_sharing",
               "telemetry")


@pytest.mark.parametrize("demo", SERVE_DEMOS)
def test_serve_collaborative_example(demo, tmp_path):
    from repro_torch.examples import serve_collaborative

    assert serve_collaborative.DEMOS == SERVE_DEMOS
    argv = ["--device", "cpu", "--demos", demo, "--trace", str(tmp_path / "t.json")]
    out, text = _quiet(serve_collaborative.main, argv)
    if demo == "hmp":
        assert all(err < 1e-5 for err in out["hmp"].values())
    if demo == "telemetry":
        assert json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    assert "Traceback" not in text and out[demo] is not None
