"""Port vs JAX: observability (obs/viz, obs/live, obs/csv_wrapper) and the
port's ``WarpsenseApp(monitor=...)``.

The same map window (made from a numpy seed, with a ring offset and a
window position away from the origin) goes to both packages: the exported
PLY files must be byte-equal, and the monitors must serve the same TUM
path and PLY bytes.  The port's monitor must hold COPIES of the map: the
app fuses its tensors in place."""
import json
import urllib.request

import numpy as np
import pytest
import torch

from warpsense_tpu.map.local_map import LocalMapState as JState
from warpsense_tpu.obs import csv_wrapper as jcsv
from warpsense_tpu.obs import live as jlive
from warpsense_tpu.obs import viz as jviz
from warpsense_tpu_torch.map.local_map import LocalMapState as TState
from warpsense_tpu_torch.obs import csv_wrapper as tcsv
from warpsense_tpu_torch.obs import live as tlive
from warpsense_tpu_torch.obs import viz as tviz

TAU, RES = 600, 64


def _planes(size=(13, 11, 9), seed=0):
    rng = np.random.default_rng(seed)
    value = rng.integers(-TAU, TAU + 1, size).astype(np.int16)
    weight = np.where(rng.random(size) < 0.3,
                      rng.integers(1, 640, size), 0).astype(np.int16)
    pos = np.array([17, -5, 3], np.int32)
    offset = np.array([2, 9, 4], np.int32)
    return value, weight, pos, offset


def _states(seed=0):
    v, w, p, o = _planes(seed=seed)
    tstate = TState(*(torch.as_tensor(x.copy()) for x in (v, w, p, o)))
    return tstate, JState(v, w, p, o)


def _poses(n=5):
    poses = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        a = 0.3 * i
        poses[i][:3, :3] = [[np.cos(a), -np.sin(a), 0],
                            [np.sin(a), np.cos(a), 0], [0, 0, 1]]
        poses[i][:3, 3] = [1000.0 * i, -250.0 * i, 40.0]
    return poses


def test_viz_exports_equal_jax(tmp_path):
    t, j = _states()
    tp, tc = tviz.tsdf_cloud(t, resolution=RES, tau=TAU)
    jp, jc = jviz.tsdf_cloud(j, resolution=RES, tau=TAU)
    assert len(tp) > 50
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tc, jc)
    nt = tviz.export_tsdf_ply(tmp_path / "t.ply", t, resolution=RES, tau=TAU)
    nj = jviz.export_tsdf_ply(tmp_path / "j.ply", j, resolution=RES, tau=TAU)
    assert nt == nj == len(tp)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    np.testing.assert_array_equal(tviz.window_skeleton(t, resolution=RES),
                                  jviz.window_skeleton(j, resolution=RES))


def test_monitor_pubsub_equal_jax():
    t, j = _states()
    mons = {"t": tlive.LiveMonitor(), "j": jlive.LiveMonitor()}
    got = {k: [] for k in mons}
    shifts = {k: [] for k in mons}
    for k, mon in mons.items():
        mon.subscribe("pose", lambda s, p, k=k: got[k].append(s))
        mon.subscribe("shift", lambda pos, k=k: shifts[k].append(list(pos)))
        for i, pose in enumerate(_poses()):
            mon.publish_pose(0.1 * i, pose, timing_ms=10.0 + i)
        mon.publish_shift([10, 0, 0])
    mons["t"].publish_map(t, resolution=RES, tau=TAU)
    mons["j"].publish_map(j, resolution=RES, tau=TAU)
    assert got["t"] == got["j"] == [0.1 * i for i in range(5)]
    assert shifts["t"] == shifts["j"] == [[10, 0, 0]]
    assert mons["t"].tum_path() == mons["j"].tum_path()
    assert len(mons["t"].tum_path().splitlines()) == 5
    ply = mons["t"].map_ply_bytes()
    assert ply.startswith(b"ply") and ply == mons["j"].map_ply_bytes()
    st = {k: json.loads(m.status_json()) for k, m in mons.items()}
    for s in st.values():
        s.pop("started")
    assert st["t"] == st["j"]
    assert st["t"]["scans"] == 5 and st["t"]["shifts"] == 1
    assert st["t"]["map_epoch"] == 1


def test_monitor_holds_a_copy_and_rate_limits():
    t, _ = _states()
    mon = tlive.LiveMonitor(map_snapshot_period_s=3600.0)
    mon.publish_map(t, resolution=RES, tau=TAU)
    before = mon.map_ply_bytes()
    t.value.fill_(0)                       # the app fuses in place
    t.weight.fill_(0)
    t.pos.fill_(100)
    assert mon.map_ply_bytes() == before
    mon.publish_map(t, resolution=RES, tau=TAU)   # inside the period
    assert mon.map_ply_bytes() == before
    assert json.loads(mon.status_json())["map_epoch"] == 1


def test_file_streamer_and_http_monitor(tmp_path):
    t, _ = _states()
    mon = tlive.LiveMonitor()
    fs = tlive.FileStreamer(mon, tmp_path, map_period_s=0.0,
                            path_period_s=0.0)
    mon.publish_pose(0.5, _poses()[1], timing_ms=12.5)
    mon.publish_map(t, resolution=RES, tau=TAU)
    assert (tmp_path / "latest_map.ply").read_bytes() == mon.map_ply_bytes()
    fs.flush()
    assert (tmp_path / "latest_path.tum").read_text() == mon.tum_path()
    assert json.loads((tmp_path / "status.json").read_text())["scans"] == 1
    http = tlive.HttpMonitor(mon)
    try:
        base = f"http://127.0.0.1:{http.port}"
        st = json.loads(urllib.request.urlopen(base + "/status").read())
        assert st["scans"] == 1 and st["scan_ms"] == 12.5
        tum = urllib.request.urlopen(base + "/path.tum").read().decode()
        assert tum == mon.tum_path() and tum.startswith("0.5")
        ply = urllib.request.urlopen(base + "/map.ply").read()
        assert ply == mon.map_ply_bytes()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nothing")
    finally:
        http.close()


def test_csv_wrapper_equal_jax(tmp_path):
    for name, lib in (("t", tcsv), ("j", jcsv)):
        m = lib.KDTreeMeasurements(tmp_path / f"{name}.csv")
        for i in range(4):
            m.record(i, 100 * i, 1.5 * i, 0.25 * i)
        m.add_value("extra", "x")
        m.write()
        c = lib.CSVWrapper(tmp_path / f"{name}_semi.csv", separator=";")
        c.add_row(a=1, b=2.5)
        c.add_row(a=3)
        c.write()
    for stem in ("", "_semi"):
        assert ((tmp_path / f"t{stem}.csv").read_bytes()
                == (tmp_path / f"j{stem}.csv").read_bytes())
    lines = (tmp_path / "t.csv").read_text().splitlines()
    assert lines[0] == "frame,points,build_us,query_us,extra"
    assert len(lines) == 5


def test_warpsense_app_publishes_live():
    """The port's WarpsenseApp streams pose and map through the monitor
    after each scan while the run is in flight, and each shift before it
    happens; the published map is a copy that later fusions leave alone."""
    from warpsense_tpu_torch.eval.slam_eval import default_params
    from warpsense_tpu_torch.io.dataset import SyntheticDataset
    from warpsense_tpu_torch.pipeline.warpsense import WarpsenseApp

    mon = tlive.LiveMonitor(map_snapshot_period_s=0.0)
    seen, snaps, shifts = [], [], []
    mon.subscribe("pose", lambda s, p: seen.append(len(mon.path)))
    mon.subscribe("map", lambda st: snaps.append(st))
    mon.subscribe("shift", lambda pos: shifts.append(np.asarray(pos)))
    params = default_params(16, 128)
    params.map.shift = 0.15
    app = WarpsenseApp(params, in_memory_map=True, capacity=2048,
                       device="cpu", monitor=mon, sync_shift=True,
                       window_size=(101, 101, 41))
    poses = []
    for fr in SyntheticDataset(4, channels=16, columns=128):
        poses.append(app.cloud_callback(fr.cloud, fr.stamp))
        assert len(snaps) == len(poses)
        snap = snaps[-1]
        assert snap.value.data_ptr() != app.state.value.data_ptr()
        assert torch.equal(snap.value, app.state.value)
    first = snaps[0]
    assert not torch.equal(first.weight, app.state.weight)   # fused since
    assert seen == [1, 2, 3, 4]
    assert [p[0] for p in mon.path] == [pytest.approx(0.1 * i)
                                        for i in range(4)]
    for (_, got), want in zip(mon.path, poses):
        np.testing.assert_array_equal(got, want.astype(np.float64))
    assert shifts and np.array_equal(shifts[-1], app.state.pos.numpy())
    st = json.loads(mon.status_json())
    assert st["scans"] == 4 and st["map_epoch"] == 4
    assert st["scan_ms"] > 0            # the app passes the scan's host time
    assert st["shifts"] == len(shifts)
    assert mon.map_ply_bytes().startswith(b"ply")
    app.terminate()
