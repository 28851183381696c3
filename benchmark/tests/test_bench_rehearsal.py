"""A tiny cell on the CPU through the whole run, and the faults the check
must catch (the harness's look for a card skipped; the program's plain
versions stand in for its kernels)."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent), str(Path(__file__).parent)]

import faults  # noqa: E402
from harness.cell import run_cell  # noqa: E402
from tiny import tiny_root  # noqa: E402

KEYS = ["attempted", "failed", "correct", "metrics", "device", "check"]


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "parking_fast.drive", "--seed", str(2 ** 31 + 9), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True,
        cwd=BENCH.parent, timeout=120)
    assert proc.returncode == 2
    assert proc.stdout == ""


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_cell_prints_the_result_keys(tmp_path, trace):
    root, bench = tiny_root(tmp_path)
    r = run_cell(bench, "tiny.drive", seed=2 ** 31 + 77, seconds=1.0,
                 trace=bool(trace), device="cpu", root=root)
    json.dumps(r)
    assert [k for k in r if k != "breakdown"] == KEYS
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= 1
    assert set(r["check"]) == {"pose_gap_median_mm", "pose_gap_p90_mm",
                               "map_differ_share", "window_differ",
                               "failed_scans"}
    assert list(r["check"])[-1] == "failed_scans"
    want = ({"scans_per_s", "scan_ms_p95", "device_mem_peak_gb", "setup_s"}
            if not trace else {"app_self_ms", "preprocess_ms",
                               "registration_ms"})
    assert want <= set(r["metrics"])
    if trace:
        assert set(r["device"]) >= {"busy_s", "window_s"}
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", [faults.unchanged, faults.half_batch,
                                   faults.altered])
def test_a_broken_program_is_not_correct(tmp_path, fault):
    root, bench = tiny_root(tmp_path, scans=3)
    r = run_cell(bench, "tiny.drive", seed=12345, seconds=0.5, trace=False,
                 device="cpu", root=root, sabotage=fault)
    assert r["correct"] is False
    assert any(v > lim for v, lim in r["check"].values())


@pytest.mark.parametrize("fault, number", [
    (faults.no_write_back, "map_differ_share"),
    (faults.after_shift_altered, "shift_gap_median_mm")])
def test_a_broken_shift_is_not_correct(tmp_path, fault, number):
    """A 0.5 m shift on the hold's circle: the window shifts every ~4
    scans and loads back what it evicted.  The window is long enough for
    the checked scans on a busy CPU."""
    root, bench = tiny_root(tmp_path, shift_m=0.5, scans=12, lap_scans=None,
                            limits={"shift_gap_median_mm": 0.0})
    r = run_cell(bench, "tiny.hold", seed=4242, seconds=40.0, trace=False,
                 device="cpu", root=root, sabotage=fault)
    assert r["attempted"] >= 12
    assert r["correct"] is False
    assert r["check"][number][0] > 0.0
