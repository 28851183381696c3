"""Finding a cell's parts by name.

* ``BENCHMARK.json`` at the root: the cells and the metrics;
* ``benchmark/configs/<config>.json``: a configuration;
* ``benchmark/mixes/<mix>.json``: a traffic mix, whose ``kind`` names its
  generator, ``benchmark/mixes/<kind>.py``;
* ``benchmark/checks/<cell>.json``: the scans the check replays and the
  limits of its numbers;
* ``benchmark/metrics/<metric>.py``: a per-layer metric's reader, a
  function ``read(ctx)`` that returns the value or None.

A later configuration, mix, cell or metric is a file and an entry more;
nothing here names one.
"""
from __future__ import annotations

import copy
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def _dir(root):
    """Where the data files are: ``benchmark/``, or a test's directory."""
    return BENCH_DIR if root is None else Path(root)


def _load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark() -> dict:
    return _load_json(ROOT / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _make_odd(n: int) -> int:
    return n if n % 2 else n + 1


def config(name: str, root=None) -> dict:
    """The configuration as the harness runs it: the program's parameter
    groups (``params``) with the file's cuts applied (a top-level
    ``update_distance`` replaces ``map.update_distance``), the app's
    settings, and the window in voxels (``size * 1000 // resolution``,
    made odd, as the program sizes it)."""
    raw = _load_json(_dir(root) / "configs" / f"{name}.json")
    cfg = copy.deepcopy(raw["params"])
    if "update_distance" in raw:
        cfg["map"]["update_distance"] = raw["update_distance"]
    for key in ("capacity", "fusion", "sync_shift", "global_map",
                "warmup_scans"):
        cfg[key] = raw[key]
    cfg["traffic_args"] = raw.get("traffic_args", {})
    m = cfg["map"]
    res = int(m["resolution"])
    cfg["window_voxels"] = [_make_odd(int(m["size"][ax]) * 1000 // res)
                            for ax in ("x", "y", "z")]
    return cfg


def mix(name: str, root=None) -> dict:
    return _load_json(_dir(root) / "mixes" / f"{name}.json")


def checks(cell_name: str, root=None) -> dict:
    return _load_json(_dir(root) / "checks" / f"{cell_name}.json")


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(kind: str):
    return _module(BENCH_DIR / "mixes" / f"{kind}.py", f"mix_{kind}")


def metric_reader(name: str):
    mod = _module(BENCH_DIR / "metrics" / f"{name}.py",
                  "metric_" + name.replace(".", "_"))
    return mod.read


def _for_cell(metrics: list, cell_name: str) -> list:
    return [m for m in metrics
            if "workloads" not in m or cell_name in m["workloads"]]


def end_to_end(bench: dict, cell_name: str) -> list:
    return _for_cell(bench["end_to_end"], cell_name)


def per_layer(bench: dict, cell_name: str) -> list:
    return _for_cell(bench["per_layer"], cell_name)
