"""A cell small enough for the CPU: the real car park and laps, a 32 x 256
sensor, 64 mm voxels in a 12 x 12 x 4 m window, a 2 m shift."""
from __future__ import annotations

import copy
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent


def tiny_root(tmp: Path, *, shift_m: float = 2.0, mode: str = "fast",
              scans: int = 6, lap_scans: int = 24, resolution: int = 64,
              size=(12, 12, 4), sensor=(32, 256),
              limits: dict | None = None) -> tuple[Path, dict]:
    """A directory of tiny data files and the BENCHMARK dict naming its
    cells ``tiny.drive`` and ``tiny.hold``; ``limits``: more numbers the
    cells compare, with their limits."""
    for sub in ("configs", "mixes", "checks"):
        (tmp / sub).mkdir(parents=True, exist_ok=True)
    src = "parking_fast" if mode == "fast" else "default_parity"
    cfg = json.loads((BENCH / "configs" / f"{src}.json").read_text())
    cfg["params"]["lidar"].update(channels=sensor[0],
                                  hresolution=sensor[1])
    cfg["params"]["map"].update(resolution=resolution,
                                size=dict(zip("xyz", size)), shift=shift_m)
    cfg["capacity"] = 1024
    cfg["traffic_args"] = {"lap_scans": lap_scans}
    (tmp / "configs" / "tiny.json").write_text(json.dumps(cfg))
    for mix in ("drive", "hold"):
        m = json.loads((BENCH / "mixes" / f"{mix}.json").read_text())
        (tmp / "mixes" / f"{mix}.json").write_text(json.dumps(m))
        (tmp / "checks" / f"tiny.{mix}.json").write_text(json.dumps(
            {"scans": scans, "free_scans": 3, "limits": {"pose_gap_median_mm": 0.0,
                                        "pose_gap_p90_mm": 0.0,
                                        "map_differ_share": 0.0,
                                        **(limits or {})}}))
    bench = copy.deepcopy(json.loads((BENCH.parent / "BENCHMARK.json")
                                     .read_text()))
    bench["workloads"] = [
        {"name": f"tiny.{mix}", "config": "tiny", "traffic": mix,
         "chips": 1, "why": "CPU rehearsal"} for mix in ("drive", "hold")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    return tmp, bench
