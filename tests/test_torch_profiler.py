"""The port's span profiler (``obs/profiler.RuntimeEvaluator``) and the
spans and counters ``WarpsenseApp(profile=True)`` records.

On the CPU: nesting, parents and scan ids on one thread; a worker thread's
spans kept apart from the main thread's; the reference's sums and CSV; the
counters; the chrome-trace export; and a tiny shifting app whose profiled
run is its unprofiled run to the bit, with its glue span, each fusion's
table and sweep, the shift's four phases and the counters of bytes, of the
fields cache and of the fusion grids.

On a card (skipped without one): a span waits for the work launched inside
it without a synchronize; a profiled scan synchronizes exactly as often as
an unprofiled one; every kernel the fusion launches falls under the
program's own ``span.tsdf`` range in a ``torch.profiler`` trace.  This file
imports no JAX; on the card run it without the JAX conftest:

    python -m pytest --noconftest tests/test_torch_profiler.py
"""
import csv
import json
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from warpsense_tpu_torch.core.config import Params
from warpsense_tpu_torch.io.synthetic import (BoxWorld, render_scan,
                                              walk_trajectory)
from warpsense_tpu_torch.obs.profiler import RuntimeEvaluator
from warpsense_tpu_torch.pipeline import warpsense as wmod
from warpsense_tpu_torch.pipeline.warpsense import WarpsenseApp

CFG = {
    "map": {"max_distance": 0.6, "resolution": 128, "max_weight": 10,
            "size": {"x": 20, "y": 16, "z": 7}, "shift": 0.18,
            "update_distance": 0.05},
    "registration": {"max_iterations": 20, "epsilon": 0.03,
                     "it_weight_gradient": 0.1, "mode": "fast"},
    "lidar": {"channels": 16, "hresolution": 128},
}
PHASES = ("shift.gather", "shift.store", "shift.load", "shift.scatter")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the spans wait on the card's events")
    return torch.device("cuda")


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def _scans(n):
    gt = walk_trajectory(n, step_m=0.1)
    rng = np.random.default_rng(0)
    return [render_scan(BoxWorld.default(), p, channels=16, columns=128,
                        noise_std=0.002, rng=rng) for p in gt]


def _app(device, profile):
    return WarpsenseApp(Params.from_dict(CFG), in_memory_map=True,
                        capacity=2048, fusion="auto", sync_shift=True,
                        device=device, profile=profile)


# ------------------------------------------------------------------- the CPU
def test_spans_nest_under_the_innermost_open_span_of_their_thread():
    ev = RuntimeEvaluator()
    ev.set_scan(7)
    ev.start("a")
    ev.start("b")
    with ev.span("c"):
        time.sleep(0.002)
    ev.stop("b")
    with pytest.raises(RuntimeError, match="started twice"):
        ev.start("a")
    ev.stop("a")
    with pytest.raises(RuntimeError, match="without start"):
        ev.stop("a")
    recs = _by_name(ev.records())
    a, b, c = recs["a"][0], recs["b"][0], recs["c"][0]
    assert (a.parent, b.parent, c.parent) == (None, a.id, b.id)
    assert {r.scan for r in (a, b, c)} == {7}
    assert a.start < b.start < c.start <= c.end < b.end < a.end
    assert a.device_end is None
    forms = ev._forms
    assert forms["a"].sum >= forms["b"].sum >= forms["c"].sum >= 2_000_000
    # the evaluator's own calls inside a span are not its time
    assert b.excluded > 0 and a.excluded >= b.excluded
    assert forms["b"].sum == b.end - b.start - b.excluded


def test_a_worker_threads_spans_neither_nest_under_nor_pause_the_main_ones():
    ev = RuntimeEvaluator()
    ev.set_scan(3)
    ev.start("total")
    ev.start("io")
    done = threading.Event()

    def work():
        ev.set_scan(2)
        for _ in range(50):
            ev.start("io")          # the main thread has its own "io" open
            ev.start("inner")
            ev.stop("inner")
            ev.stop("io")
        done.set()
    t = threading.Thread(target=work, name="shift-worker")
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and done.is_set()
    ev.stop("io")
    ev.stop("total")
    recs = _by_name(ev.records())
    total, io_main = recs["total"][0], recs["io"][-1]
    assert io_main.thread == total.thread and io_main.parent == total.id
    worker_io = [r for r in recs["io"] if r.thread != total.thread]
    assert len(worker_io) == 50 and {r.scan for r in worker_io} == {2}
    assert all(r.parent is None for r in worker_io)
    ids = {r.id for r in worker_io}
    assert all(r.parent in ids for r in recs["inner"])
    # the worker's 200 calls did not pause the main thread's spans: they
    # lose only the time of the main thread's own nested calls
    assert io_main.excluded == 0 and total.excluded > 0
    assert ev._forms["io"].count == 51


def test_sums_rows_and_csv_keep_the_references_schema(tmp_path):
    ev = RuntimeEvaluator()
    for ms in (1, 3, 2):
        with ev.span("total"):
            time.sleep(ms / 1e3)
    f = ev._forms["total"]
    assert f.count == 3 and f.sum >= 6_000_000
    assert f.min <= f.last <= f.max and f.sum == sum(f.window)
    rows = ev.to_rows()
    assert [list(r) for r in rows] == [["task", "count", "last", "min",
                                        "max", "avg", "run_avg"]]
    r = rows[0]
    assert r["count"] == 3 and r["avg"] == int(f.sum / 3) // 1000
    assert r["min"] >= 1000 and r["max"] >= 3000
    path = tmp_path / "spans.csv"
    ev.export_results(path)
    lines = path.read_text().splitlines()
    assert lines[0] == "task,count,last,min,max,avg,run_avg"
    assert next(csv.DictReader(lines))["count"] == "3"
    assert "total" in str(ev) and "run_avg" in str(ev)
    assert not hasattr(ev, "histogram")


def test_counters_add_and_clear_with_the_spans():
    ev = RuntimeEvaluator()
    ev.count("chunk_miss")
    ev.count("chunk_miss", 4)
    ev.count("shift_bytes_d2h", 1 << 40)
    with ev.span("total"):
        pass
    assert ev.counters() == {"chunk_miss": 5, "shift_bytes_d2h": 1 << 40}
    ev.counters()["chunk_miss"] = 0            # a copy
    assert ev.counters()["chunk_miss"] == 5
    ev.clear()
    assert ev.counters() == {} and ev._forms == {} and ev.records() == []


def test_export_spans_writes_a_chrome_trace_a_track_a_thread(tmp_path):
    ev = RuntimeEvaluator()
    ev.set_scan(0)
    with ev.span("total"):
        with ev.span("glue"):
            pass

    def work():
        ev.set_scan(0)
        with ev.span("shift.store"):
            pass
    t = threading.Thread(target=work, name="worker")
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    path = tmp_path / "spans.json"
    ev.export_spans(path)
    doc = json.loads(path.read_text())
    meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    spans = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {e["args"]["name"] for e in meta} >= {
        threading.current_thread().name, "worker"}
    assert set(spans) == {"total", "glue", "shift.store"}
    assert spans["glue"]["args"]["parent"] == spans["total"]["args"]["id"]
    assert spans["glue"]["tid"] == spans["total"]["tid"]
    assert spans["shift.store"]["tid"] != spans["total"]["tid"]
    assert {e["args"]["scan"] for e in spans.values()} == {0}
    assert spans["total"]["ts"] <= spans["glue"]["ts"]
    assert spans["glue"]["dur"] <= spans["total"]["dur"]


def test_a_profiled_app_is_the_unprofiled_one_and_times_the_shift():
    """A 157 x 125 x 55 window that shifts every second scan."""
    scans = _scans(6)
    ev = RuntimeEvaluator.get_instance()
    runs = {}
    for profile in (False, True):
        app = _app("cpu", profile)
        ev.clear()
        poses, moved = [], []
        for i, s in enumerate(scans):
            before = app.state.pos.numpy().copy()
            poses.append(app.cloud_callback(s, 0.1 * i))
            moved.append(app.state.pos.numpy() - before)
        runs[profile] = (np.stack(poses), app.state, moved, ev.counters())
        app.terminate()
    (p0, s0, moved, c0), (p1, s1, _, c) = runs[False], runs[True]
    np.testing.assert_array_equal(p0, p1)
    for a, b in zip(s0, s1):
        assert torch.equal(a, b)
    shifts = [i for i, d in enumerate(moved) if np.any(d)]
    assert shifts

    recs = ev.records()
    by_id = {r.id: r for r in recs}
    names = _by_name(recs)
    assert [r.scan for r in names["total"]] == list(range(len(scans)))
    for r in names["glue"]:
        assert by_id[r.parent].name == "total" and by_id[r.parent].scan == r.scan
    assert [r.scan for r in names["shift"]] == shifts
    for name in PHASES:
        assert names[name]
        for r in names[name]:
            shift = by_id[r.parent]
            assert shift.name == "shift"
            assert by_id[shift.parent].name == "total"
            assert r.scan == shift.scan
    forms = ev._forms
    assert sum(forms[n].sum for n in PHASES) <= forms["shift"].sum
    # each fusion's table and sweep, nested in its "tsdf" span
    for name in ("tsdf.table", "tsdf.sweep"):
        assert len(names[name]) == len(names["tsdf"])
        for r in names[name]:
            assert by_id[r.parent].name == "tsdf"
            assert r.scan == by_id[r.parent].scan
    assert forms["tsdf.table"].sum + forms["tsdf.sweep"].sum \
        <= forms["tsdf"].sum

    size = np.asarray(app.local_map.size)
    voxels = sum(abs(int(d[ax])) * int(np.prod(np.delete(size, ax)))
                 for d in moved for ax in range(3))
    assert c["shift_bytes_d2h"] == c["shift_bytes_h2d"] == 4 * voxels
    assert c["chunk_miss"] > 0
    assert c["fields_cache_hit"] + c["fields_cache_miss"] == len(scans)
    assert c["fields_cache_miss"] == forms["fields"].count
    assert c["fusion_grid_level"] + c.get("fusion_grid_attitude", 0) \
        == forms["tsdf"].count
    # the fields cache and the fusion grids count always; the map's
    # counters with the spans
    assert c0 == {k: c[k] for k in c if k.startswith(("fields_cache_",
                                                      "fusion_grid_"))}


# -------------------------------------------------------------------- a card
def _count_syncs(monkeypatch):
    """Explicit ``torch.cuda.synchronize`` calls and the syncs that the
    sync debug mode reports, from now on: a function that reads them."""
    n = [0]
    real = torch.cuda.synchronize

    def sync(*a, **k):
        n[0] += 1
        return real(*a, **k)
    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    caught = warnings.catch_warnings(record=True)
    seen = caught.__enter__()
    warnings.simplefilter("always")
    torch.cuda.set_sync_debug_mode("warn")

    def read():
        torch.cuda.set_sync_debug_mode(0)
        caught.__exit__(None, None, None)
        return n[0] + sum("synchroniz" in str(w.message) for w in seen)
    return read


def test_a_span_waits_for_the_device_without_synchronizing(cuda):
    ev = RuntimeEvaluator()
    ev.use_device(cuda)
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter_ns()
        ev.start("sleep")
        a.record()
        torch.cuda._sleep(50_000_000)
        b.record()
        ev.stop("sleep")
        host_ns = time.perf_counter_ns() - t0
        assert "sleep" not in ev._forms        # not done yet: not folded
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    slept_ns = a.elapsed_time(b) * 1e6
    assert slept_ns > 5 * host_ns
    rec = ev.records()[0]
    assert ev._forms["sleep"].count == 1
    assert ev._forms["sleep"].sum >= slept_ns
    assert rec.device_end > rec.end


def test_a_profiled_scan_synchronizes_as_often_as_an_unprofiled_one(
        cuda, monkeypatch):
    scans = _scans(6)
    counts = {}
    for profile in (False, True):
        app = _app(cuda, profile)
        for i, s in enumerate(scans[:2]):
            app.cloud_callback(s, 0.1 * i)
        torch.cuda.synchronize()
        per_scan = []
        for i, s in enumerate(scans[2:], start=2):
            read = _count_syncs(monkeypatch)
            app.cloud_callback(s, 0.1 * i)
            per_scan.append(read())
            monkeypatch.undo()
        counts[profile] = per_scan
        app.terminate()
    print("synchronizations a scan, unprofiled / profiled:",
          counts[False], counts[True])
    assert counts[True] == counts[False]


def test_every_fusion_kernel_falls_under_the_programs_tsdf_range(
        cuda, tmp_path, monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    real = wmod.fuse_cloud

    def fuse_cloud(*a, **k):
        with torch.profiler.record_function("test.fuse"):
            return real(*a, **k)
    monkeypatch.setattr(wmod, "fuse_cloud", fuse_cloud)
    scans = _scans(5)
    app = _app(cuda, True)
    app.cloud_callback(scans[0], 0.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i, s in enumerate(scans[1:], start=1):
            app.cloud_callback(s, 0.1 * i)
        torch.cuda.synchronize()
    app.terminate()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in (e.get("args") or {})}
    ranges = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"]))

    def inside(ts, name):
        return any(a <= ts <= b for a, b in ranges.get(name, ()))
    fused = [launches[e["args"]["correlation"]] for e in events
             if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
             and e["args"].get("correlation") in launches
             and inside(launches[e["args"]["correlation"]], "test.fuse")]
    assert fused, "no device work launched inside fuse_cloud"
    assert all(inside(ts, "span.tsdf") for ts in fused)
