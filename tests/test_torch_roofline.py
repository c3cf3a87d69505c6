"""The port's roofline (``repro_torch/roofline/analysis.py``): the three
terms, the bottleneck, MFU and the collective keys on the H100 spec, as
``tests/test_roofline.py`` pins them for the reference on TPU v5e."""
import pytest

pytest.importorskip("torch")

from repro_torch.core.costmodel import H100, h100_peak_flops  # noqa: E402
from repro_torch.roofline.analysis import (  # noqa: E402
    COLLECTIVE_KINDS,
    Roofline,
    collective_bytes,
)


def test_roofline_terms_and_bottleneck():
    rl = Roofline(
        arch="x", shape="train_4k", mesh="16x16", chips=256,
        hlo_flops=989e12,              # exactly 1 second of bf16 compute
        hlo_bytes=3.35e12 * 0.5,       # 0.5 s of HBM traffic
        coll_bytes={"total": 450e9 * 2},  # 2 s on NVLink
        model_flops=989e12 * 256 * 0.4,
    )
    assert rl.t_compute == pytest.approx(1.0)
    assert rl.t_memory == pytest.approx(0.5)
    assert rl.t_collective == pytest.approx(2.0)
    assert rl.bottleneck == "collective"
    assert rl.step_time == pytest.approx(2.0)
    assert rl.useful_ratio == pytest.approx(0.4)
    # mfu = model_flops / chips / step_time / peak
    assert rl.mfu == pytest.approx(0.4 / 2.0)


@pytest.mark.parametrize("dtype,peak", [("bfloat16", 989e12), ("float16", 989e12),
                                        ("float32", 67e12)])
def test_peak_flops_follow_the_dtype(dtype, peak):
    rl = Roofline(arch="x", shape="s", mesh="1x1", chips=1, hlo_flops=peak,
                  hlo_bytes=0.0, coll_bytes={}, model_flops=peak, dtype=dtype)
    assert rl.peak_flops == peak == h100_peak_flops(dtype)
    assert rl.t_compute == pytest.approx(1.0)
    assert rl.bottleneck == "compute"
    assert rl.mfu == pytest.approx(1.0)


def test_dtype_factor_is_one():
    """The port counts true dtypes: no bf16 halving of traffic (the
    reference's 0.5 undoes XLA:CPU's f32 promotion)."""
    base = dict(arch="x", shape="s", mesh="m", chips=2, hlo_flops=1e12,
                hlo_bytes=3.35e12, coll_bytes={"total": 450e9}, model_flops=1e12)
    rl = Roofline(**base, dtype="bfloat16")
    assert rl.dtype_factor == 1.0
    assert rl.t_memory == pytest.approx(1.0)
    assert rl.t_collective == pytest.approx(1.0)


def test_to_dict_keeps_the_reference_keys():
    rl = Roofline(arch="a", shape="s", mesh="16x16", chips=256, hlo_flops=1.0,
                  hlo_bytes=2.0, coll_bytes={"total": 3.0}, model_flops=4.0,
                  peak_mem_bytes=5.0)
    assert set(rl.to_dict()) == {
        "arch", "shape", "mesh", "chips", "hlo_flops_per_chip", "hlo_bytes_per_chip",
        "collective_bytes_per_chip", "model_flops_global", "t_compute_s", "t_memory_s",
        "t_collective_s", "bottleneck", "useful_flops_ratio", "roofline_step_s",
        "roofline_mfu", "peak_mem_bytes_per_chip"}


def test_collective_bytes_sum_by_kind_with_total():
    out = collective_bytes([("all-gather", 1024.0), ("reduce-scatter", 512.0),
                            ("all-gather", 2048.0)])
    assert out == {"all-gather": 3072.0, "reduce-scatter": 512.0, "total": 3584.0}
    assert collective_bytes([]) == {"total": 0.0}
    assert COLLECTIVE_KINDS == ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
                                "collective-permute")


def test_hw_constants_match_the_datasheet():
    assert H100["peak_flops"]["bfloat16"] == 989e12
    assert H100["peak_flops"]["float32"] == 67e12
    assert H100["hbm_bw"] == 3.35e12
    assert H100["nvlink_bw"] == 450e9
    assert H100["hbm_bytes"] == 80e9


def test_report_reads_the_dry_run_records(tmp_path, capsys):
    """``roofline/report.py`` tables the records ``run_one`` writes."""
    import json

    from repro_torch.roofline import report

    rl = Roofline(arch="qwen1.5-0.5b", shape="decode_32k", mesh="16x16", chips=256,
                  hlo_flops=1e9, hlo_bytes=3.35e9, coll_bytes=collective_bytes(
                      [("all-gather", 2e6), ("reduce-scatter", 1e6)]), model_flops=2e11,
                  peak_mem_bytes=2e9)
    (tmp_path / "qwen1.5-0.5b__decode_32k__16x16.json").write_text(
        json.dumps(dict(rl.to_dict(), count_s=3.0)))
    (tmp_path / "qwen1.5-0.5b__decode_32k__16x16__tp_only.json").write_text("{}")
    report.main(["16x16", "--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "| qwen1.5-0.5b | decode_32k |" in out and "**memory**" in out
    assert "| 2 | 1 | 0 | 0 | 3 |" in out
