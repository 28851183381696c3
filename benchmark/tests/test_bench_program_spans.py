"""The per-layer metrics that read the program's own spans and counters,
on a tiny traced cell on the CPU: the glue and the fields cache in every
cell, the shift's phases, chunk misses and bytes only where the window
shifts."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent), str(Path(__file__).parent)]

from harness.cell import run_cell  # noqa: E402
from tiny import tiny_root  # noqa: E402

EVERY_CELL = {"glue_ms", "fields_reuse_pct"}
SHIFT_PHASES = {"shift_gather_ms", "shift_store_ms", "shift_load_ms",
                "shift_scatter_ms"}
SHIFTING = SHIFT_PHASES | {"shift_chunk_misses", "shift_mb"}


@pytest.mark.parametrize("shift_m", [0.5, 50.0])
def test_a_traced_tiny_cell_prints_the_program_span_metrics(tmp_path,
                                                            shift_m):
    """The hold's circle with a 0.5 m shift (the window shifts every ~4
    scans) and with a 50 m one (it never does)."""
    root, bench = tiny_root(tmp_path, shift_m=shift_m, scans=3,
                            lap_scans=None)
    r = run_cell(bench, "tiny.hold", seed=2 ** 31 + 5, seconds=4.0,
                 trace=True, device="cpu", root=root)
    assert r["correct"] is True and r["failed"] == 0
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert EVERY_CELL <= set(got)
    assert got["glue_ms"] > 0 and 0 <= got["fields_reuse_pct"] <= 100
    if shift_m > 1:
        assert "shift_ms" not in got and not SHIFTING & set(got)
        return
    assert SHIFTING <= set(got)
    assert sum(got[k] for k in SHIFT_PHASES) <= got["shift_ms"]
    assert got["shift_mb"] > 0 and got["shift_chunk_misses"] >= 0
