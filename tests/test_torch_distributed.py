"""Port vs JAX: process-group bring-up (``parallel/distributed.py``) at a
world of one, and the featsense mesh back end (``FeatsenseApp(mesh=)``)
against JAX's on tests/test_featsense_sharded.py's walk.

Tolerances: the gathered windows and slab bounds exactly; featsense's
refined (VGICP) poses within the 2 mm of tests/test_torch_featsense_app.py
(its float32 F-LOAM and VGICP solves sum in another order than XLA's), and
both apps within test_featsense_sharded.py's 0.15 m of the truth.  The
two-rank runs are in test_torch_sharded.py and test_torch_sharded_app.py.
"""
import numpy as np
import pytest
import torch

import _torch_dist_worker as w
from warpsense_tpu.core.config import Params as JParams
from warpsense_tpu.parallel.sharded import make_mesh as jmake_mesh
from warpsense_tpu.pipeline.featsense import FeatsenseApp as JFeatsenseApp
from warpsense_tpu_torch.core.config import Params
from warpsense_tpu_torch.map.local_map import create_state
from warpsense_tpu_torch.parallel import distributed as td
from warpsense_tpu_torch.pipeline.featsense import FeatsenseApp

ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


@pytest.fixture
def no_group_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)


def test_init_distributed_is_a_noop_at_a_world_of_one(no_group_env):
    assert td.init_distributed() is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        td.init_distributed(num_processes=2, process_id=0)
    assert not torch.distributed.is_initialized()


def test_mesh_state_roundtrip_at_a_world_of_one(no_group_env):
    mesh = td.global_mesh("cpu")
    assert (mesh.group, mesh.rank, mesh.world) == (None, 0, 1)
    size = (80, 41, 41)
    st = create_state(size, 600, 0, force_odd=False)
    st.value[3, 4, 5] = -17
    st.weight[79, 0, 40] = 9
    slab = td.shard_state_global(st, mesh)
    assert slab.value.data_ptr() != st.value.data_ptr()      # a copy
    assert td.host_slab_bounds(mesh, size) == (0, 80)
    back = td.gather_state(slab, mesh)
    for a, b in zip(back, st):
        np.testing.assert_array_equal(a, b.numpy())
    assert td.gather_state(slab, mesh, dst=0) is not None


def test_demo_main_at_a_world_of_one(no_group_env, tmp_path):
    """``main`` without a coordinator runs the demo step as a world of
    one (the sharded functions at a world of N are held to this step's
    JAX twin in test_torch_sharded.py)."""
    out = tmp_path / "demo.npz"
    report = td.main(["--device", "cpu", "--out", str(out)])
    assert report["world"] == 1 and report["backend"] is None
    assert report["slab"] == [0, 80]
    assert report["weight_nonzero"] > 5000
    saved = np.load(out)
    assert int((saved["weight"] != 0).sum()) == report["weight_nonzero"]
    np.testing.assert_array_equal(saved["pose"], report["pose"])


@pytest.fixture(scope="module")
def featsense_runs(tmp_path_factory):
    """Both apps on the walk with a 0.15 m shift, so the windows move."""
    d = tmp_path_factory.mktemp("fs")
    truth, scans = w.walk_scans()
    japp = JFeatsenseApp(JParams.from_dict(w.featsense_config(0.15)),
                         map_path=d / "j.h5", window_size=w.WINDOW,
                         mesh=jmake_mesh(8), **w.FEATSENSE_KW)
    tapp = FeatsenseApp(Params.from_dict(w.featsense_config(0.15)),
                        map_path=d / "t.h5", window_size=w.WINDOW,
                        mesh=td.global_mesh("cpu"), **w.FEATSENSE_KW)
    for i, scan in enumerate(scans):
        japp.process_scan(scan, float(i))
        tapp.process_scan(scan, float(i))
    out = dict(truth=truth, jg=np.stack(japp.mapping.gicp_path),
               tg=np.stack(tapp.mapping.gicp_path),
               jw=np.asarray(japp.mapping.state.weight),
               tw=tapp.mapping.state.weight.numpy(),
               jpos=np.asarray(japp.mapping.state.pos),
               tpos=tapp.mapping.state.pos.numpy(), path=d / "t.h5")
    japp.terminate()
    tapp.terminate()
    return out


def test_featsense_mesh_backend_matches_jax(featsense_runs):
    r = featsense_runs
    assert len(r["tg"]) == len(r["jg"]) >= 4
    np.testing.assert_allclose(r["tg"][:, :3, 3], r["jg"][:, :3, 3],
                               atol=2e-3)
    np.testing.assert_allclose(r["tg"][:, :3, :3], r["jg"][:, :3, :3],
                               atol=1e-3)
    truth = r["truth"]
    rel = np.linalg.inv(truth[0]) @ truth[len(r["tg"])]
    for g in (r["tg"], r["jg"]):
        assert np.linalg.norm(g[-1][:3, 3] - rel[:3, 3]) < 0.15
    np.testing.assert_array_equal(r["tpos"], r["jpos"])
    both = (r["tw"] != 0) | (r["jw"] != 0)
    assert both.sum() > 10_000
    assert np.mean((r["tw"] != 0)[both] == (r["jw"] != 0)[both]) > 0.95


def test_featsense_mesh_shift_and_persist(featsense_runs):
    import h5py
    assert np.any(featsense_runs["tpos"] != 0), \
        "the mesh back end's window never shifted"
    with h5py.File(featsense_runs["path"], "r") as f:
        assert len(f["map"]) > 0 and len(f["poses"]) > 0
