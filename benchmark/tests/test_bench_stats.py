"""The harness's arithmetic and its discovery of parts by name (CPU)."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import discover, guard, roofline, stats  # noqa: E402
from harness import trace as trace_mod  # noqa: E402


def test_rate_is_all_scans_over_all_time():
    assert stats.rate(300, 12.0) == 25.0


@pytest.mark.parametrize("values,q,want", [
    (list(range(1, 101)), 95.0, 95),
    (list(range(1, 21)), 95.0, 19),
    ([5.0], 95.0, 5.0),
    ([3, 1, 2], 50.0, 2),
    (list(range(100, 0, -1)), 95.0, 95),
])
def test_p95_is_nearest_rank_over_every_value(values, q, want):
    assert stats.percentile_nearest_rank(values, q) == want


def test_spread_is_the_interquartile_distance_over_the_median():
    assert stats.spread([1, 2, 3, 4, 5, 6]) == pytest.approx(
        (5.25 - 1.75) / 3.5)


def test_idle_share_comes_from_the_union_of_intervals():
    busy = [(0.0, 1.0), (0.5, 1.5), (3.0, 4.0), (3.5, 3.6)]
    assert stats.union_length(busy) == 2.5          # not the sum, 3.1
    gaps = stats.complement(stats.merge(busy), 0.0, 5.0)
    assert gaps == [(1.5, 3.0), (4.0, 5.0)]
    assert stats.subtract(gaps, [(2.0, 2.5)]) == [(1.5, 2.0), (2.5, 3.0),
                                                  (4.0, 5.0)]


def test_idle_gaps_are_labelled_by_the_innermost_host_range():
    segs = stats.label_segments([(0.0, 10.0, "scan"), (2.0, 5.0, "shift"),
                                 (3.0, 4.0, "fields")])
    got = stats.attribute([(1.0, 6.0), (9.5, 11.0)], segs, "harness")
    assert got == pytest.approx({"scan": 2.5, "shift": 2.0, "fields": 1.0,
                                 "harness": 1.0})


def test_device_operations_belong_to_the_range_that_launched_them():
    doc = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "bench.fusion",
         "ts": 100, "dur": 50},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 110, "dur": 2, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel",
         "ts": 160, "dur": 2, "args": {"correlation": 8}},
        # runs after the range closed on the host: still the range's
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 170, "dur": 30,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "other", "ts": 175, "dur": 5,
         "args": {"correlation": 8}},
    ]}
    tr = trace_mod.parse(doc)
    (rng,) = tr.ranges_named("bench.fusion")
    assert [d[2] for d in tr.device_in(rng)] == ["k1"]
    assert tr.device_seconds_in(rng) == pytest.approx(30e-6)


def test_k1_bytes_count_the_changed_voxels_read_and_written():
    assert roofline.fusion_bytes(1000, 10) == 8 * 1000 + 12 * 10
    assert roofline.fields_bytes(100, 400) == 800
    assert roofline.share_pct(3.35e9, 1e-3, "NVIDIA H100 80GB HBM3") == \
        pytest.approx(100.0)
    assert roofline.share_pct(1.0, 1.0, "cpu") is None


def test_the_probe_counts_the_voxels_a_fusion_changed():
    from reference import ops
    size = (41, 41, 21)
    v = torch.full(size, 600, dtype=torch.int16)
    w = torch.zeros(size, dtype=torch.int16)
    # a wall 1 m ahead of the scanner
    yy, zz = torch.meshgrid(torch.arange(-500, 501, 20),
                            torch.arange(-300, 301, 20), indexing="ij")
    pts = torch.stack([torch.full_like(yy, 1000), yy, zz], -1).reshape(-1, 3)
    pts = pts.to(torch.int32)
    mask = torch.ones(len(pts), dtype=torch.bool)

    def fuse():
        ops.fuse(v, w, [-20, -20, -10], torch.zeros(3, dtype=torch.int32),
                 size, pts, mask, torch.eye(4), tau=600, max_weight=640,
                 resolution=64, channels=16, columns=64, vfov_deg=45.0)
    fuse()
    assert int((w != 0).sum()) > 0
    before = (v.clone(), w.clone())
    fuse()
    changed = int(((v != before[0]) | (w != before[1])).sum())
    # a second fusion of the same wall raises the weight of every voxel it
    # averages into (those it overwrites with the same entry stay as they
    # were), and touches nothing else
    assert 0.99 * int((w != 0).sum()) < changed <= int((w != 0).sum())
    assert roofline.fusion_bytes(changed, len(pts)) == \
        8 * changed + 12 * len(pts)


def test_every_part_is_found_by_its_name():
    bench = discover.benchmark()
    for c in bench["configs"]:
        assert (BENCH.parent / c["file"]).is_file()
    for cell in bench["workloads"]:
        cfg = discover.config(cell["config"])
        mix = discover.mix(cell["traffic"])
        assert discover.generator(mix["kind"]).make
        assert discover.checks(cell["name"])["scans"] > 0
        assert cfg["window_voxels"][0] == 625
        for m in discover.per_layer(bench, cell["name"]):
            assert callable(discover.metric_reader(m["name"]))
    assert discover.config("parking_fast")["window_voxels"] == [625, 625,
                                                                 235]
    assert discover.config("default_parity")["window_voxels"] == [625, 625,
                                                                   391]
    names = [m["name"] for m in discover.per_layer(bench,
                                                    "default_parity.hold")]
    assert "shift_ms" not in names and "k2_roofline" not in names


def test_default_parity_is_the_shipped_default_but_for_its_cuts():
    import yaml
    shipped = yaml.safe_load((BENCH.parent / "warpsense_tpu_torch" /
                              "configs" / "default.yaml").read_text())
    raw = json.loads((BENCH / "configs" / "default_parity.json").read_text())
    for group in ("lidar", "registration", "map"):
        assert raw["params"][group] == shipped[group]
    cfg = discover.config("default_parity")
    assert cfg["map"]["update_distance"] == 0.0


@pytest.mark.parametrize("names,found", [
    (["warpsense_tpu_torch", "warpsense_tpu_torch.ops", "numpy"], []),
    (["jax.numpy", "numpy"], ["jax"]),
    (["jaxlib"], ["jaxlib"]),
    (["warpsense_tpu.ops.tsdf"], ["warpsense_tpu"]),
    (["flax.linen", "jaxtyping"], ["flax"]),
])
def test_no_module_of_jax_or_the_jax_package(names, found):
    assert guard.foreign_modules(names) == found
