"""Bench artifact contract (VERDICT r4 item 2): the driver records only
the LAST 2000 characters of bench.py's stdout and parses the final line —
BENCH_r03/r04 went "parsed: null" because the single full-detail JSON
line outgrew that window. The compact summary printed last must always
fit and must carry the headline numbers."""

import json
import sys
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from bench import _compact_summary  # noqa: E402


def _full_result():
    return {
        "metric": "x" * 200, "value": 1.23e11, "unit": "point-values/s",
        "vs_baseline": 99.0, "measurement_contract": "r3-fused",
        "t_apply_pass_s": 0.0185, "value_write_wall": 1.1e11,
        "value_materialized_split6": 9.4e10, "device": "NVIDIA H100 80GB HBM3",
        "full_mesh": {
            "ncells": 2600000, "backend": "fused", "n_cols": 512,
            "t_apply_pass_s": 0.0106, "value_materialized": 9.27e10,
            "value_write_wall": 1.34e11, "pct_of_write_wall": 69.0,
            "t_compile_cold_s": 168.6, "t_compile_warm_s": 2.1,
            "bytes_per_pass_total_gb": 5.06,
            "extra_detail": "y" * 3000,
        },
        "e2e": {"t_pipeline_warm_s": 19.2,
                "t_pipeline_warm_streamed_s": 10.6,
                "peak_host_rss_mb_subprocess": {"in_memory": 4000.0,
                                                "streamed": 2000.0},
                "output_mb": 121.3, "noise": "z" * 2000},
        "e2e_production": {
            "ncells": 2600000, "grid": "1801x1061 lambert 3km CONUS",
            "n_cols": 973, "output_gb": 7.44,
            "t_pipeline_streamed_s": 400.0,
            "t_pipeline_inmem_s": 500.0,
            "peak_host_rss_mb_subprocess": {"streamed": 20000.0,
                                            "in_memory": 30000.0},
            "rss_budget_mb": 24000, "source": "recorded artifact",
            "stages": {"k": "v" * 500},
        },
        "padding_detail": "w" * 5000,
    }


def test_compact_line_fits_capture_window_and_parses():
    line = _compact_summary(_full_result())
    assert len(line) <= 1900, len(line)
    s = json.loads(line)
    assert s["value"] == 1.23e11
    assert s["unit"] == "point-values/s"
    assert "vs_baseline" in s
    # headline sections survive compaction
    assert s["full_mesh"]["value_materialized"] == 9.27e10
    assert "extra_detail" not in s["full_mesh"]
    assert s["e2e_production"]["output_gb"] == 7.44
    assert "stages" not in s["e2e_production"]


def test_compact_line_degrades_gracefully_when_huge():
    r = _full_result()
    # a pathologically long headline metric still cannot break the window
    r["metric"] = "m" * 1500
    line = _compact_summary(r)
    assert len(line) <= 2100
    json.loads(line)


def test_emit_results_tail_window_parses_both_ways(tmp_path, monkeypatch,
                                                   capsys):
    """The driver's 2000-char stdout tail must parse whether it loads the
    WHOLE tail (whitespace spacer makes it legal JSON) or only the final
    line."""
    import bench

    monkeypatch.setattr(
        bench.os.path, "abspath", lambda p: str(tmp_path / "bench.py"))
    bench.emit_results(_full_result())
    out = capsys.readouterr().out
    tail = out[-2000:]
    assert json.loads(tail)["value"] == 1.23e11
    assert json.loads(out.strip().splitlines()[-1])["value"] == 1.23e11
