"""One run of one cell: set-up, the measured window, the traced reading and
the check against the plain reference.

The program under test is ``warpsense_tpu_torch``'s ``WarpsenseApp``,
driven through ``imu_callback`` and ``cloud_callback`` as a sensor driver
or a bag replay drives it: a closed loop, each scan fed when the one
before has returned.  Everything that belongs to one configuration, mix,
cell or metric is found by name (``harness.discover``).
"""
from __future__ import annotations

import gc
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from . import check as check_mod
from . import discover, roofline, stats
from . import trace as trace_mod

OUT = Path(__file__).resolve().parent.parent / "out"
# a traced run traces the first seconds of its window: enough for a few
# shifts, and a trace a run can write and read back within its time
TRACE_SECONDS = 10.0


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc)."""
    import os
    with open("/proc/self/stat") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as fh:
        up = float(fh.read().split()[0])
    return up - start


def params_of(cfg: dict):
    """The program's ``Params`` for a resolved configuration."""
    from warpsense_tpu_torch.core.config import Params
    return Params.from_dict({k: cfg[k] for k in ("lidar", "registration",
                                                 "map")})


def make_app(cfg: dict, device, *, profile: bool):
    from warpsense_tpu_torch.pipeline.warpsense import WarpsenseApp
    if cfg["global_map"] != "memory":
        raise ValueError("only the in-memory global map is benchmarked")
    return WarpsenseApp(params_of(cfg), in_memory_map=True,
                        capacity=int(cfg["capacity"]), fusion=cfg["fusion"],
                        sync_shift=bool(cfg["sync_shift"]), device=device,
                        profile=profile)


def warm_shift(cfg: dict, device) -> None:
    """Run the window shift's slab path once on a small throwaway window,
    so that its first launches (gather, copies, scatter) happen in
    set-up and not in the window."""
    from warpsense_tpu_torch.map.global_map import GlobalMap
    from warpsense_tpu_torch.map.local_map import LocalMap
    lm = LocalMap((9, 9, 9), GlobalMap(None, 100, 0))
    lm.attach_device(lm.device_state(device))
    lm.shift(np.array([3, -2, 1]))
    lm.shift(np.array([0, 0, 0]))
    lm.detach_device()
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def feed(app, traffic, g: int):
    """Scan ``g``'s IMU samples, then the scan; (pose or None, ms, error)."""
    from warpsense_tpu_torch.utils.imu import ImuSample
    for stamp, w in traffic.imu(g):
        app.imu_callback(ImuSample(stamp, np.asarray(w)))
    cloud, stamp = traffic.scan(g), traffic.stamp(g)
    t0 = time.perf_counter()
    try:
        pose = app.cloud_callback(cloud, stamp)
        err = None if np.all(np.isfinite(pose)) else "non-finite pose"
    except Exception:                       # counted, and the drive goes on
        pose, err = None, traceback.format_exc(limit=4)
    return pose, (time.perf_counter() - t0) * 1e3, err


class Tracer:
    """The traced run's instruments, all from the benchmark's side:
    ``torch.profiler`` ranges around each scan, around the fusion and
    fields calls as ``pipeline/warpsense.py`` makes them, and around each
    of the app's own spans (``profile=True``); before and after each
    fusion, outside its range, a probe counts the voxels it changed."""

    def __init__(self, app, device):
        import warpsense_tpu_torch.pipeline.warpsense as wmod
        self.wmod, self.app, self.device = wmod, app, device
        self.fusions: list = []      # (changed voxels, points)
        self.fields: list = []       # bytes of the window read + written
        self.probe_s = 0.0
        self._probe_s_scan = 0.0
        self._shadow = None
        self._orig = {n: getattr(wmod, n) for n in
                      ("fuse_cloud", "precompute_fields_packed_auto",
                       "precompute_fields")}
        self._open: dict = {}
        ev = app.eval
        self._ev_start, self._ev_stop = ev.start, ev.stop

    def install(self) -> None:
        rf = torch.profiler.record_function
        orig = self._orig

        def fuse_cloud(state, pts, mask, pose, **kw):
            t0 = time.perf_counter()
            with rf("bench.probe"):
                if self._shadow is None:
                    self._shadow = (torch.empty_like(state.value),
                                    torch.empty_like(state.weight))
                self._shadow[0].copy_(state.value)
                self._shadow[1].copy_(state.weight)
                points = int(mask.sum())
                sync(self.device)
            self._probe(t0)
            with rf("bench.fusion"):
                out = orig["fuse_cloud"](state, pts, mask, pose, **kw)
            t0 = time.perf_counter()
            with rf("bench.probe"):
                sync(self.device)
                changed = int(((state.value != self._shadow[0])
                               | (state.weight != self._shadow[1])).sum())
            self._probe(t0)
            self.fusions.append((changed, points))
            return out

        def fields(name):
            def wrapped(state, **kw):
                with rf(f"bench.{name}"):
                    out = orig[name](state, **kw)
                out_bytes = sum(t.numel() * t.element_size() for t in out)
                self.fields.append((name, roofline.fields_bytes(
                    state.value.numel(), out_bytes)))
                return out
            return wrapped

        self.wmod.fuse_cloud = fuse_cloud
        self.wmod.precompute_fields_packed_auto = fields(
            "precompute_fields_packed_auto")
        self.wmod.precompute_fields = fields("precompute_fields")

        def start(task):
            r = rf(f"span.{task}")
            r.__enter__()
            self._open[task] = r
            self._ev_start(task)

        def stop(task):
            self._ev_stop(task)
            self._open.pop(task).__exit__(None, None, None)

        self.app.eval.start, self.app.eval.stop = start, stop

    def _probe(self, t0: float) -> None:
        d = time.perf_counter() - t0
        self.probe_s += d
        self._probe_s_scan += d

    def take_scan_probe_s(self) -> float:
        d, self._probe_s_scan = self._probe_s_scan, 0.0
        return d

    def remove(self) -> None:
        for n, f in self._orig.items():
            setattr(self.wmod, n, f)
        self.app.eval.start, self.app.eval.stop = self._ev_start, self._ev_stop


def span_totals(ev) -> dict:
    """{task: (count, seconds)} of the app's spans, from its evaluator's
    nanosecond sums (its CSV rounds to whole microseconds)."""
    return {name: (f.count, f.sum / 1e9) for name, f in ev._forms.items()}


def run_cell(bench: dict, cell_name: str, *, seed: int, seconds: float,
             trace: bool, device=None, root: Path | None = None,
             sabotage=None) -> dict:
    """One run; returns the result object (the result line's keys, with the
    numbers compared under ``check`` last).  ``device``: the card in the
    benchmark's runs; the tests pass the CPU, with a tiny configuration.
    ``sabotage(app)``: the tests' hook that breaks the program under the
    harness."""
    device = torch.device(device or "cuda")
    cuda = device.type == "cuda"
    cell = discover.cell(bench, cell_name)
    cfg = discover.config(cell["config"], root=root)
    mix = discover.mix(cell["traffic"], root=root)
    limits = discover.checks(cell_name, root=root)
    gen = discover.generator(mix["kind"])
    warmup = int(cfg["warmup_scans"])

    marks = [("start", process_age_s())]
    traffic = gen.make(mix, seed, cfg["lidar"], device,
                       **cfg.get("traffic_args", {}))
    marks.append(("traffic", process_age_s()))
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    app = make_app(cfg, device, profile=trace)
    marks.append(("app", process_age_s()))
    if sabotage is not None:
        sabotage(app)
    poses: dict = {}
    errors: list = []
    for g in range(warmup):
        pose, _, err = feed(app, traffic, g)
        poses[g] = pose
        if err:
            errors.append((g, err))
    marks.append(("warm-up scans", process_age_s()))
    warm_shift(cfg, device)
    n_check = int(limits["scans"])
    snap = check_mod.Snapshot(app.state, pinned=cuda)
    tracer = None
    if trace:
        tracer = Tracer(app, device)
        tracer.install()
        app.eval.clear()
        from warpsense_tpu_torch.kernels.fields import fields_packed
        from warpsense_tpu_torch.kernels.fusion import fusion_sweep_merge
        from warpsense_tpu_torch.ops.registration import \
            reset_registration_counts
        fusion_sweep_merge.launches = 0
        fields_packed.launches = 0
        reset_registration_counts()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = process_age_s()
    marks.append(("set-up", setup_s))
    log("[setup] seconds since process start: " + ", ".join(
        f"{k} {v:.3f}" for k, v in marks) + f"; lap of {len(traffic)} scans")

    prof = traced = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
        window_range = torch.profiler.record_function("bench.window")
        window_range.__enter__()
    lat, fused_wall = [], []
    t_start = time.perf_counter()
    deadline = t_start + seconds
    trace_end = t_start + min(seconds, TRACE_SECONDS)
    g = warmup
    while True:
        fusions_before = len(tracer.fusions) if tracer else 0
        if prof is not None:
            with torch.profiler.record_function("bench.scan"):
                pose, ms, err = feed(app, traffic, g)
        else:
            pose, ms, err = feed(app, traffic, g)
        poses[g] = pose
        lat.append(ms)
        if err:
            errors.append((g, err))
        if tracer:
            wall = ms / 1e3 - tracer.take_scan_probe_s()
            if prof is not None and len(tracer.fusions) > fusions_before:
                fused_wall.append((wall, tracer.fusions[-1]))
        g += 1
        if g - warmup == n_check:
            snap.take(app.state)
        now = time.perf_counter()
        if prof is not None and (now >= trace_end or now >= deadline):
            sync(device)
            window_range.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            traced = (prof, len(tracer.fusions), len(tracer.fields),
                      time.perf_counter() - t_start)
            prof = None
        if now >= deadline:
            break
    if cuda:
        torch.cuda.synchronize(device)
    t_end = time.perf_counter()
    window_s = t_end - t_start
    n = g - warmup
    if n < n_check:
        snap.take(app.state)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    spans = span_totals(app.eval) if trace else {}
    counters = read_counters() if trace else {}
    if tracer:
        tracer.remove()

    result = {"attempted": n,
              "failed": sum(1 for k, _ in errors if k >= warmup)}
    e2e = {"scans_per_s": stats.rate(n, window_s),
           "scan_ms_p95": stats.percentile_nearest_rank(lat, 95.0),
           "device_mem_peak_gb": peak / 1e9,
           "setup_s": setup_s}
    log(f"[window] scans {n} in {window_s:.6f} s; latency ms median "
        f"{stats.percentile_nearest_rank(lat, 50.0):.6f}, p95 "
        f"{e2e['scan_ms_p95']:.6f}, max {max(lat):.6f}; failed "
        f"{result['failed']}; setup_s {setup_s:.6f}")
    for k, err in errors[:3]:
        log(f"[failed] scan {k}:\n{err}")
    card = torch.cuda.get_device_name(device) if cuda else "cpu"
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": card,
                   "count": 1, "memory_peak_bytes": int(peak)}

    if trace:
        ctx = trace_context(traced, tracer, spans, counters, fused_wall,
                            card, cell_name)
        device_info["busy_s"] = ctx["busy_s"]
        device_info["window_s"] = ctx["window_s"]
        metrics = {}
        for m in discover.per_layer(bench, cell_name):
            value = discover.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = ctx["breakdown"]
        log("[spans]", {k: (c, s) for k, (c, s) in spans.items()})
        log("[counters]", counters)
    else:
        metrics = {}
        for m in discover.end_to_end(bench, cell_name):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    # the check: the program's state is freed first, then the reference
    prog_poses = [poses.get(k) for k in range(warmup + min(n, n_check))]
    window = snap.result()
    del app, tracer, traced
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = check_mod.run_check(cfg, traffic, prog_poses, window,
                                  failed=[
                                      k for k, _ in errors
                                      if k < warmup + n_check],
                                  device=device, limits=limits["limits"],
                                  free_scans=int(limits.get("free_scans",
                                                            0)))
    log(f"[check] reference over {len(prog_poses)} scans in "
        f"{time.perf_counter() - t0:.3f} s")
    result.update(correct=check_mod.passed(numbers), metrics=metrics,
                  device=device_info)
    result["check"] = {k: [v["value"], v["limit"]]
                       for k, v in numbers.items()}
    for k, v in numbers.items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    return result


def read_counters() -> dict:
    from warpsense_tpu_torch.kernels.fields import fields_packed
    from warpsense_tpu_torch.kernels.fusion import fusion_sweep_merge
    from warpsense_tpu_torch.ops.registration import run_registration
    return {"k1_launches": fusion_sweep_merge.launches,
            "k2_launches": fields_packed.launches,
            "registrations": run_registration.calls,
            "reg_iterations": run_registration.iterations,
            "reg_syncs": run_registration.syncs}


def trace_context(traced, tracer, spans, counters, fused_wall, card,
                  cell_name) -> dict:
    """What the per-layer readers read: the spans and counters of the
    whole window, and the probes and device trace of its traced start
    (``traced``: the stopped profiler, the fusions and fields computations
    it saw, its seconds)."""
    prof, n_fusions, n_fields, traced_s = traced
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"trace_{cell_name}.json"
    t0 = time.perf_counter()
    prof.export_chrome_trace(str(path))
    t1 = time.perf_counter()
    tr = trace_mod.load(path)
    log(f"[trace] exported in {t1 - t0:.3f} s ({path.stat().st_size} "
        f"bytes), read in {time.perf_counter() - t1:.3f} s: "
        f"{len(tr.device)} device operations, {len(tr.ranges)} ranges")
    win = tr.ranges_named("bench.window")
    lo, hi = (win[0][0], win[0][1]) if win else (0.0, traced_s)
    probes = [(a, b) for a, b, _ in tr.ranges_named("bench.probe")]
    probe_ops = set()
    for r in tr.ranges_named("bench.probe"):
        probe_ops.update(id(d) for d in tr.device_in(r))
    dev = [(d[0], d[1]) for d in tr.device if id(d) not in probe_ops]
    busy = stats.clip(stats.merge(dev), lo, hi)
    busy_s = stats.union_length(busy)
    window_s = (hi - lo) - stats.union_length(stats.clip(probes, lo, hi))
    idle = stats.subtract(stats.complement(busy, lo, hi), probes)
    host = [(a, b, name.split(".", 1)[1]) for a, b, name in tr.ranges
            if name.startswith(("span.", "bench.")) and name != "bench.window"
            and name != "bench.probe"]
    gaps = stats.attribute(idle, stats.label_segments(host), "harness")
    ops: dict = {}
    for d in tr.device:
        if id(d) not in probe_ops and lo <= d[0] <= hi:
            ops[d[2]] = ops.get(d[2], 0.0) + (d[1] - d[0])

    def per_call(prefix):
        return [tr.device_seconds_in(r) for r in tr.ranges_named(prefix)]

    def top(d):
        return [[k[:96], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"spans": spans, "counters": counters, "card": card,
            "busy_s": busy_s, "window_s": window_s,
            "fusions": tracer.fusions[:n_fusions], "fusion_device_s":
            per_call("bench.fusion"), "fields": tracer.fields[:n_fields],
            "fields_device_s": {name: per_call(f"bench.{name}") for name in
                                ("precompute_fields_packed_auto",
                                 "precompute_fields")},
            "probe_s": tracer.probe_s, "fused_wall": fused_wall,
            "breakdown": {"device_ops": top(ops), "idle_gaps": top(gaps)}}
