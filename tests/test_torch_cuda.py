"""CUDA kernels K1 (fusion) and K2 (fields) against their plain PyTorch
versions on the card, and the parity-mode app, the ray march and the
featsense app on the card against the same code on the CPU.  A CUDA kernel
has no CPU mode, so every test here needs a GPU and skips without one.
This file imports no JAX (the GPU machine has none); run it there without
the JAX conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""
import math

import numpy as np
import pytest
import torch

from warpsense_tpu_torch.core.config import Params
from warpsense_tpu_torch.io.synthetic import (BoxWorld, box_room_cloud,
                                              render_scan, walk_trajectory)
from warpsense_tpu_torch.kernels.fields import fields_packed, fields_parity
from warpsense_tpu_torch.kernels.fusion import fusion_sweep_merge
from warpsense_tpu_torch.map.local_map import clone_state, create_state
from warpsense_tpu_torch.ops import registration as treg
from warpsense_tpu_torch.ops.tsdf import plan_raymarch
from warpsense_tpu_torch.ops.tsdf_projective import (fusion_inputs,
                                                     sweep_merge_plain)
from warpsense_tpu_torch.pipeline.featsense import FeatsenseApp
from warpsense_tpu_torch.pipeline.fusion_backend import fuse_cloud
from warpsense_tpu_torch.pipeline.warpsense import WarpsenseApp

from _fields_window import planted_window

TAU, RES = 600, 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    return torch.device("cuda")


def _tilt(deg):
    a = math.radians(deg)
    return torch.tensor([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                         [-math.sin(a), 0, math.cos(a)]], dtype=torch.float32)


@pytest.mark.parametrize("size,channels,columns", [
    ((48, 48, 32), 32, 256), ((161, 150, 60), 128, 1024)])
def test_fusion_kernel_matches_plain(cuda, size, channels, columns):
    kw = dict(tau=TAU, resolution=RES, channels=channels, columns=columns,
              vfov_deg=45.0)
    half = min(size[0], size[1]) * RES * 45 // 100
    pts = torch.as_tensor(box_room_cloud(6000, half, size[2] * RES * 2 // 5),
                          device=cuda)
    mask = torch.ones(len(pts), dtype=torch.bool, device=cuda)
    st_k = create_state(size, TAU, 0, device=cuda, force_odd=False)
    st_p = clone_state(st_k)
    eye = torch.eye(3)
    for spos, R, level in (((0, 0, 0), eye, True), ((2, -1, 1), eye, True),
                           ((1, 0, 0), _tilt(4.0), False),
                           ((0, 1, 0), _tilt(12.0), False)):
        spos = torch.tensor(spos, dtype=torch.int32, device=cuda)
        inputs = fusion_inputs(st_k, pts, mask, spos, R, size=size, **kw)
        rng_tab, endpoint, smm, cx, cy, cz = inputs
        before = fusion_sweep_merge.launches
        fusion_sweep_merge(st_k.value, st_k.weight, cx, cy, cz, rng_tab,
                           endpoint, smm, R, max_weight=2048, level=level,
                           **kw)
        assert fusion_sweep_merge.launches == before + 1
        sweep_merge_plain(st_p.value, st_p.weight, cx, cy, cz, rng_tab,
                          endpoint, smm, R, max_weight=2048, **kw)
        torch.cuda.synchronize()
        assert torch.equal(st_k.value, st_p.value)
        assert torch.equal(st_k.weight, st_p.weight)
    assert int((st_k.weight != 0).sum()) > 1000


@pytest.mark.parametrize("cloud", ["room", "wedge"])
def test_fusion_level_kernel_after_shift_and_on_empty_columns(cuda, cloud):
    """K1's level sweep on a window whose ring offset is nonzero on all
    three axes (its z coordinates come rotated, so the cull's run of global
    z can be two runs of array z), with the room cloud or a 60-degree wedge
    of it that leaves most columns without a hit, the scanner at the center
    and near the edge: equal to the plain version."""
    size = (96, 80, 45)
    kw = dict(tau=TAU, resolution=RES, channels=128, columns=1024,
              vfov_deg=45.0)
    pts = torch.as_tensor(box_room_cloud(20000, 2000, 1000), device=cuda)
    mask = torch.ones(len(pts), dtype=torch.bool, device=cuda)
    if cloud == "wedge":
        mask = (pts[:, 0] > 0) & (pts[:, 1].abs() * 100 < 58 * pts[:, 0])
    ring = dict(pos=torch.tensor([3, -2, 1], dtype=torch.int32, device=cuda),
                offset=torch.tensor([5, 71, 9], dtype=torch.int32,
                                    device=cuda))
    st_k = create_state(size, TAU, 0, device=cuda,
                        force_odd=False)._replace(**ring)
    st_p = clone_state(st_k)
    eye = torch.eye(3)
    for spos in ((3, -2, 1), (40, -30, 15)):
        spos = torch.tensor(spos, dtype=torch.int32, device=cuda)
        rng_tab, endpoint, smm, cx, cy, cz = fusion_inputs(
            st_k, pts, mask, spos, eye, size=size, **kw)
        assert int(torch.argmin(cz)) != 0
        fusion_sweep_merge(st_k.value, st_k.weight, cx, cy, cz, rng_tab,
                           endpoint, smm, eye, max_weight=2048, level=True,
                           **kw)
        sweep_merge_plain(st_p.value, st_p.weight, cx, cy, cz, rng_tab,
                          endpoint, smm, eye, max_weight=2048, **kw)
        torch.cuda.synchronize()
        assert torch.equal(st_k.value, st_p.value)
        assert torch.equal(st_k.weight, st_p.weight)
    assert int((st_k.weight != 0).sum()) > 1000


def _oblique(deg):
    """A tilt of ``deg`` about an oblique horizontal axis, with some yaw."""
    a = math.radians(deg)
    k = torch.tensor([[0.0, 0.0, 0.8], [0.0, 0.0, -0.6], [-0.8, 0.6, 0.0]],
                     dtype=torch.float64)
    tilt = torch.eye(3, dtype=torch.float64) + math.sin(a) * k \
        + (1 - math.cos(a)) * k @ k
    c, s = math.cos(0.3), math.sin(0.3)
    yaw = torch.tensor([[c, -s, 0], [s, c, 0], [0, 0, 1]],
                       dtype=torch.float64)
    return (yaw @ tilt).to(torch.float32)


@pytest.mark.parametrize("deg", [4.0, 12.0, 30.0])
@pytest.mark.parametrize("cloud", ["room", "wedge"])
def test_fusion_general_kernel_matches_plain(cuda, deg, cloud):
    """K1's general sweep (its early-outs, the hoisted rotation, the column
    without a modulo) on a window whose ring offset is nonzero on all
    three axes, the room cloud or a 60-degree wedge of it: equal to the
    plain version, and counted as a general launch."""
    size = (96, 80, 45)
    kw = dict(tau=TAU, resolution=RES, channels=128, columns=1024,
              vfov_deg=45.0)
    pts = torch.as_tensor(box_room_cloud(20000, 2000, 1000), device=cuda)
    mask = torch.ones(len(pts), dtype=torch.bool, device=cuda)
    if cloud == "wedge":
        mask = (pts[:, 0] > 0) & (pts[:, 1].abs() * 100 < 58 * pts[:, 0])
    ring = dict(pos=torch.tensor([3, -2, 1], dtype=torch.int32, device=cuda),
                offset=torch.tensor([5, 71, 9], dtype=torch.int32,
                                    device=cuda))
    st_k = create_state(size, TAU, 0, device=cuda,
                        force_odd=False)._replace(**ring)
    st_p = clone_state(st_k)
    R = _oblique(deg)
    for spos in ((3, -2, 1), (40, -30, 15)):
        spos = torch.tensor(spos, dtype=torch.int32, device=cuda)
        rng_tab, endpoint, smm, cx, cy, cz = fusion_inputs(
            st_k, pts, mask, spos, R, size=size, **kw)
        before = fusion_sweep_merge.general_launches
        fusion_sweep_merge(st_k.value, st_k.weight, cx, cy, cz, rng_tab,
                           endpoint, smm, R, max_weight=2048, level=False,
                           **kw)
        assert fusion_sweep_merge.general_launches == before + 1
        sweep_merge_plain(st_p.value, st_p.weight, cx, cy, cz, rng_tab,
                          endpoint, smm, R, max_weight=2048, **kw)
        torch.cuda.synchronize()
        assert torch.equal(st_k.value, st_p.value)
        assert torch.equal(st_k.weight, st_p.weight)
    assert int((st_k.weight != 0).sum()) > 1000


@pytest.mark.parametrize("channels", [400, 2000])
def test_fusion_level_past_the_default_shared_memory(cuda, channels):
    """A level fusion whose beam rows pass 48 KB: at 400 channels the level
    sweep opts into more shared memory; at 2,000, past what a block can
    opt into (1,816 on an H100), the wrapper runs the general sweep at the
    identity.  Both equal the plain version, and "auto" fusion runs."""
    from warpsense_tpu_torch.kernels.fusion import max_level_channels
    size = (64, 56, 30)
    kw = dict(tau=TAU, resolution=RES, channels=channels, columns=64,
              vfov_deg=45.0)
    pts = torch.as_tensor(box_room_cloud(40000, 1500, 800), device=cuda)
    mask = torch.ones(len(pts), dtype=torch.bool, device=cuda)
    st_k = create_state(size, TAU, 0, device=cuda, force_odd=False)
    st_p = clone_state(st_k)
    eye = torch.eye(3)
    general = channels > max_level_channels()
    assert general == (channels == 2000)
    for spos in ((0, 0, 0), (5, -3, 2)):
        spos = torch.tensor(spos, dtype=torch.int32, device=cuda)
        rng_tab, endpoint, smm, cx, cy, cz = fusion_inputs(
            st_k, pts, mask, spos, eye, size=size, **kw)
        before = fusion_sweep_merge.general_launches
        fusion_sweep_merge(st_k.value, st_k.weight, cx, cy, cz, rng_tab,
                           endpoint, smm, eye, max_weight=2048, level=True,
                           **kw)
        assert fusion_sweep_merge.general_launches == before + int(general)
        sweep_merge_plain(st_p.value, st_p.weight, cx, cy, cz, rng_tab,
                          endpoint, smm, eye, max_weight=2048, **kw)
        torch.cuda.synchronize()
        assert torch.equal(st_k.value, st_p.value)
        assert torch.equal(st_k.weight, st_p.weight)
    assert int((st_k.weight != 0).sum()) > 1000
    params = Params.from_dict({
        "map": {"max_distance": 0.6, "resolution": RES, "max_weight": 10},
        "lidar": {"channels": channels, "hresolution": 64}})
    fuse_cloud(st_k, pts, mask, np.eye(4), params=params, size=size,
               fusion="auto")
    torch.cuda.synchronize()


def test_segment_sum_is_deterministic_on_the_card(cuda):
    """Featsense's voxel sums on the card: a fixed order, so two calls give
    the same bits; within the summation bound of the CPU's index_add_."""
    from warpsense_tpu_torch.ops.segment import segment_sum
    rng = np.random.default_rng(3)
    gid = torch.as_tensor(np.sort(rng.integers(0, 3000, 200_000)))
    vals = torch.as_tensor(rng.normal(size=(200_000, 13)).astype(np.float32))
    want = segment_sum(vals, gid, 3000)                 # CPU: index_add_
    a = segment_sum(vals.to(cuda), gid.to(cuda), 3000)
    b = segment_sum(vals.to(cuda), gid.to(cuda), 3000)
    assert torch.equal(a, b)
    n = torch.bincount(gid, minlength=3000).to(torch.float32)[:, None]
    bound = 2 * n * 2.0 ** -24 * segment_sum(vals.abs(), gid, 3000)
    assert bool(((a.cpu() - want).abs() <= bound).all())


def _plain_fields(st, mode):
    return {"packed": lambda: treg.precompute_fields_packed(st, tau=TAU),
            "exact": lambda: treg.precompute_fields_packed2(st),
            "parity": lambda: treg.precompute_fields(st)}[mode]()


# degenerate extents (1 and 2, where x-1 == x+1), Y*Z a multiple of 8,
# Y*Z above one tile with Z at the default extent, odd windows, and planes
# that start `offset` int16 past a 16-byte boundary (a window cut from a
# larger one starts so); values in [-TAU, TAU] packed and exact, and the
# planted full-range window (zeros beside signed values, the int16
# extremes) in parity mode
@pytest.mark.parametrize("size,offset", [
    ((37, 29, 23), 0), ((64, 40, 33), 0), ((1, 5, 7), 0), ((2, 3, 1), 0),
    ((5, 7, 3), 0), ((9, 16, 32), 0), ((3, 40, 391), 0), ((5, 13, 23), 1),
    ((5, 13, 23), 3), ((5, 13, 23), 7)])
@pytest.mark.parametrize("mode", ["packed", "exact", "parity"])
def test_fields_kernel_matches_plain(cuda, size, offset, mode):
    if mode == "parity":
        v, w = planted_window(size, sum(size))
    else:
        rng = np.random.default_rng(sum(size))
        v = rng.integers(-TAU, TAU + 1, size).astype(np.int16)
        w = ((rng.random(size) < 0.7) * rng.integers(1, 64, size)).astype(
            np.int16)
    n = v.size
    flat_v = torch.zeros(n + 8, dtype=torch.int16, device=cuda)
    flat_w = torch.zeros(n + 8, dtype=torch.int16, device=cuda)
    flat_v[offset:offset + n] = torch.as_tensor(v.reshape(-1))
    flat_w[offset:offset + n] = torch.as_tensor(w.reshape(-1))
    st = create_state(size, TAU, 0, device=cuda, force_odd=False)
    st = st._replace(value=flat_v[offset:offset + n].view(size),
                     weight=flat_w[offset:offset + n].view(size))
    assert st.value.data_ptr() % 16 == 2 * offset
    wrapper = fields_parity if mode == "parity" else fields_packed
    before = wrapper.launches
    got = (fields_parity(st) if mode == "parity"
           else fields_packed(st, tau=TAU, exact=mode == "exact"))
    assert wrapper.launches == before + 1
    for g, p in zip(got, _plain_fields(st, mode)):
        assert torch.equal(g, p)


def test_wrappers_reject_bad_inputs(cuda):
    st = create_state((8, 8, 8), TAU, 0, device=cuda)
    bad = st._replace(value=st.value.to(torch.int32))
    for wrapper in (lambda s: fields_packed(s, tau=TAU), fields_parity):
        with pytest.raises(TypeError):
            wrapper(bad)
        strided = st._replace(value=st.value.transpose(0, 2))
        with pytest.raises(ValueError):
            wrapper(strided)
    # planes at different offsets from a 16-byte boundary (the kernel
    # stages value and weight by the same 16-byte copies): the wrapper
    # copies the weight to the value's offset, counts the copy, and the
    # kernel gives the plain version's planes
    n = st.value.numel()
    rng = np.random.default_rng(2)
    flat_v = torch.as_tensor(rng.integers(-TAU, TAU + 1, n + 8, np.int16),
                             device=cuda)
    flat_w = torch.as_tensor(rng.integers(0, 3, n + 8, np.int16),
                             device=cuda)
    for ov, ow in ((1, 0), (0, 3), (2, 5)):
        skewed = st._replace(value=flat_v[ov:ov + n].view(st.value.shape),
                             weight=flat_w[ow:ow + n].view(st.value.shape))
        copies = (fields_packed.staged_copies, fields_parity.staged_copies)
        for exact in (False, True):
            got = fields_packed(skewed, tau=TAU, exact=exact)
            want = (treg.precompute_fields_packed2(skewed) if exact
                    else treg.precompute_fields_packed(skewed, tau=TAU))
            assert all(torch.equal(g, p) for g, p in zip(got, want))
        got = fields_parity(skewed)
        want = treg.precompute_fields(skewed)
        assert all(torch.equal(g, p) for g, p in zip(got, want))
        assert (fields_packed.staged_copies, fields_parity.staged_copies) \
            == (copies[0] + 2, copies[1] + 1)
    tall = create_state((1, 1, 200_000), TAU, 0, device=cuda,
                        force_odd=False)
    with pytest.raises(ValueError, match="z extent"):
        fields_packed(tall, tau=TAU)
    with pytest.raises(ValueError, match="z extent"):
        fields_parity(tall)


def test_app_on_cuda_launches_kernels_and_tracks(cuda):
    params = Params.from_dict({
        "map": {"max_distance": 0.6, "resolution": 128, "max_weight": 10,
                "size": {"x": 12, "y": 10, "z": 6}, "shift": 0.18,
                "update_distance": 0.05},
        "registration": {"max_iterations": 20, "epsilon": 0.03,
                         "it_weight_gradient": 0.1, "mode": "fast"},
        "lidar": {"channels": 16, "hresolution": 128}})
    world = BoxWorld.default()
    rng = np.random.default_rng(0)
    gt = walk_trajectory(5, step_m=0.1)
    scans = [render_scan(world, p, channels=16, columns=128, noise_std=0.002,
                         rng=rng) for p in gt]
    poses = {}
    for dev in ("cpu", "cuda"):
        app = WarpsenseApp(params, in_memory_map=True, capacity=2048,
                           sync_shift=True, device=dev)
        f0, k0 = fusion_sweep_merge.launches, fields_packed.launches
        poses[dev] = np.stack([app.cloud_callback(s, 0.1 * i)
                               for i, s in enumerate(scans)])
        launched = (fusion_sweep_merge.launches - f0,
                    fields_packed.launches - k0)
        app.terminate()
        if dev == "cuda":
            assert min(launched) > 0, launched
        else:
            assert launched == (0, 0)
    # same kernels' results; registration statistics sum in another order
    # on the card, so poses agree to the registration tolerance
    assert np.max(np.abs(poses["cpu"][:, :3, 3]
                         - poses["cuda"][:, :3, 3])) < 0.5


def _walk_scans(n, channels, columns):
    world = BoxWorld.default()
    rng = np.random.default_rng(0)
    return [render_scan(world, p, channels=channels, columns=columns,
                        noise_std=0.002, rng=rng)
            for p in walk_trajectory(n, step_m=0.1)]


def test_parity_app_on_cuda_launches_k1_and_tracks_like_cpu(cuda):
    """Parity mode (fusion through K1, the fields through K2's parity mode,
    once a computation: as many launches as the app's fields cache
    misses): the card and the CPU agree on the first scans; later ones
    drift apart as the GN's float32 sums run in another order (bound 20
    mm)."""
    params = Params.from_dict({
        "map": {"max_distance": 0.6, "resolution": 64, "max_weight": 10,
                "size": {"x": 20, "y": 16, "z": 7}, "shift": 0.18,
                "update_distance": 0.05},
        "registration": {"max_iterations": 200, "epsilon": 0.03,
                         "it_weight_gradient": 0.1, "mode": "parity"},
        "lidar": {"channels": 32, "hresolution": 256}})
    scans = _walk_scans(4, 32, 256)
    poses = {}
    for dev in ("cpu", "cuda"):
        app = WarpsenseApp(params, in_memory_map=True, capacity=4096,
                           device=dev)
        f0, k0 = fusion_sweep_merge.launches, fields_parity.launches
        m0 = app.eval.counters().get("fields_cache_miss", 0)
        poses[dev] = np.stack([app.cloud_callback(s, 0.1 * i)
                               for i, s in enumerate(scans)])
        launched = fusion_sweep_merge.launches - f0
        misses = app.eval.counters()["fields_cache_miss"] - m0
        app.terminate()
        assert (launched > 0) == (dev == "cuda")
        assert misses > 0
        assert fields_parity.launches - k0 == (misses if dev == "cuda"
                                               else 0)
    assert np.all(np.isfinite(poses["cuda"]))
    diff = np.abs(poses["cpu"][:, :3, 3] - poses["cuda"][:, :3, 3])
    assert diff[:2].max() < 0.5 and diff.max() < 20.0, diff


def test_raymarch_cuda_matches_cpu(cuda):
    """The ray march is plain PyTorch: on the card it equals the CPU run
    bit for bit (integer keys, a scatter-min, float32 math without
    contraction)."""
    params = Params.from_dict({
        "map": {"max_distance": 0.6, "resolution": 64, "max_weight": 10},
        "lidar": {"channels": 128, "hresolution": 1024}})
    size = (97, 89, 41)
    pts = torch.as_tensor(box_room_cloud(20000, 2700, 1000))
    mask = torch.ones(len(pts), dtype=torch.bool)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [90.0, -30.0, 10.0]
    steps = plan_raymarch(600, 64, 50000)
    out = []
    for dev in ("cpu", "cuda"):
        st = create_state(size, 600, 0, device=dev, force_odd=False)
        for _ in range(2):
            fuse_cloud(st, pts.to(dev), mask.to(dev), pose, params=params,
                       size=size, fusion="raymarch", max_steps=steps[0],
                       max_isteps=steps[1])
        out.append(st)
    assert torch.equal(out[0].value, out[1].value.cpu())
    assert torch.equal(out[0].weight, out[1].weight.cpu())
    assert int((out[0].weight != 0).sum()) > 10_000


def test_featsense_app_on_cuda(cuda):
    params = Params.from_dict({
        "map": {"max_distance": 0.6, "resolution": 128, "max_weight": 10,
                "size": {"x": 24, "y": 20, "z": 8}, "shift": 8.0,
                "update_distance": 0.08},
        "floam": {"min_distance": 0.5, "max_distance": 40.0,
                  "edge_threshold": 0.5, "surf_threshold": 0.05,
                  "edge_resolution": 0.15, "optimization_steps": 3,
                  "enrich": 4, "vgicp_fitness_score": 6.0},
        "lidar": {"channels": 32, "hresolution": 512}})
    truth = np.stack([np.eye(4)] * 5)
    for i in range(5):
        c, s = np.cos(0.02 * i), np.sin(0.02 * i)
        truth[i][:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        truth[i][:3, 3] = [0.12 * i, 0.04 * i, 0.0]
    rng = np.random.default_rng(0)
    scans = [render_scan(BoxWorld.default(), p, channels=32, columns=512,
                         noise_std=0.003, rng=rng) for p in truth]
    kw = dict(edge_capacity=512, surf_capacity=1024, cloud_capacity=4096,
              odom_kwargs=dict(edge_map_capacity=2048,
                               surf_map_capacity=4096),
              in_memory_map=True, device="cuda")
    for fusion in ("auto", "raymarch"):
        app = FeatsenseApp(params, fusion=fusion, **kw)
        f0 = fusion_sweep_merge.launches
        poses = [app.process_scan(s) for s in scans]
        app.terminate()
        assert np.all(np.isfinite(np.stack(poses)))
        assert np.linalg.norm(poses[-1][:3, 3] - truth[-1][:3, 3]) < 0.12
        assert (fusion_sweep_merge.launches > f0) == (fusion == "auto")


FASTSENSE_CFG = {
    "lidar": {"channels": 32, "hresolution": 256},
    "map": {"max_distance": 0.96, "update_distance": 0.3,
            "resolution": 128, "size": {"x": 12.0, "y": 12.0, "z": 6.0},
            "shift": 3.0, "max_weight": 10},
    "registration": {"max_iterations": 200, "epsilon": 0.03,
                     "it_weight_gradient": 0.1}}


def _fastsense_replay(device, n, *, replay=True, on_scan=None):
    """FastsenseApp on tests/test_torch_fastsense.py's walk (0.1 m steps,
    an orientation IMU sample before each scan)."""
    from warpsense_tpu_torch.io.trajectory import _quat_from_mat
    from warpsense_tpu_torch.pipeline.fastsense import FastsenseApp
    from warpsense_tpu_torch.utils.imu import ImuSample
    gt = walk_trajectory(n, step_m=0.1)
    rng = np.random.default_rng(0)
    app = FastsenseApp(Params.from_dict(FASTSENSE_CFG), capacity=8192,
                       update_frequency=5, update_distance_m=0.25,
                       in_memory_map=True, device=device)
    poses = []
    for i, p in enumerate(gt):
        scan = render_scan(BoxWorld.default(), p, channels=32, columns=256,
                           max_range=22.0, noise_std=0.01, rng=rng)
        q = _quat_from_mat(gt[0][:3, :3].T @ p[:3, :3])
        app.imu_callback(ImuSample(0.05 * i - 1e-3, np.zeros(3), q))
        poses.append(app.cloud_callback(scan, 0.05 * i))
        if on_scan is not None:
            on_scan(app)
        if replay:
            app.sync()
    app.terminate()
    return app, np.stack(poses)


def test_fastsense_on_cuda_matches_cpu(cuda):
    """Four replayed scans on the card against the CPU run of the port:
    K1's general sweep equals its plain version, but the parity GN sums in
    another order on the card, and the GN is chaotic (ROADMAP C16), so the
    bounds are tests/test_torch_fastsense.py's against JAX: the first three
    scans within 0.1 mm and 1e-5 rad, the fourth within 60 mm."""
    g0 = fusion_sweep_merge.general_launches
    app, on_card = _fastsense_replay("cuda", 4)
    assert fusion_sweep_merge.general_launches - g0 == app.updates_published
    assert app.updates_published >= 2
    _, on_cpu = _fastsense_replay("cpu", 4)
    diff = np.abs(on_card[:, :3, 3] - on_cpu[:, :3, 3]).max(axis=1)
    assert diff[:3].max() < 0.1 and diff.max() < 60.0, diff
    for a, b in zip(on_card[:3], on_cpu[:3]):
        r = a[:3, :3].astype(np.float64).T @ b[:3, :3].astype(np.float64)
        assert np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1)) < 1e-5


def test_fastsense_worker_stream_keeps_snapshots(cuda):
    """Without sync(): the worker fuses on its own stream while the caller
    registers; every (state, fields) snapshot the caller took stays
    bit-unchanged by the updates published after it, and every job is
    published before terminate returns."""
    snaps = []

    def take(app):
        with app._snap_lock:
            pair = (*app.state, *app._fields)
        snaps.append((pair, [t.clone() for t in pair]))
        assert app._worker_stream != torch.cuda.current_stream()
    app, poses = _fastsense_replay("cuda", 6, replay=False, on_scan=take)
    assert np.all(np.isfinite(poses))
    assert app.updates_published == app._jobs_submitted + 1 >= 3
    for pair, copy in snaps:
        for t, c in zip(pair, copy):
            assert torch.equal(t, c)
    assert not torch.equal(snaps[0][0][1], snaps[-1][0][1])


def test_fastsense_worker_clone_keeps_snapshots_without_a_move(cuda):
    """Without sync() and with ``update_frequency=2``, scans from one pose
    in the middle of the first voxel after the first (the gate fires on
    scans 1, 3 and 5): every worker update fuses a clone on the worker's
    stream (no shift), while the caller registers; every snapshot the
    caller took stays bit-unchanged."""
    from warpsense_tpu_torch.pipeline.fastsense import FastsenseApp
    from warpsense_tpu_torch.utils.imu import ImuSample
    app = FastsenseApp(Params.from_dict(FASTSENSE_CFG), capacity=8192,
                       update_frequency=2, update_distance_m=0.25,
                       in_memory_map=True, device="cuda", profile=True)
    start = walk_trajectory(1, step_m=0.1)[0]
    held = start.copy()
    held[:3, 3] += start[:3, :3] @ np.full(3, 0.064)   # half a voxel
    rng = np.random.default_rng(1)
    snaps = []
    for i, pose in enumerate([start] + [held] * 6):
        scan = render_scan(BoxWorld.default(), pose, channels=32,
                           columns=256, max_range=22.0, noise_std=0.01,
                           rng=rng)
        app.imu_callback(ImuSample(0.05 * i - 1e-3, np.zeros(3),
                                   np.array([0.0, 0.0, 0.0, 1.0])))
        app.cloud_callback(scan, 0.05 * i)
        with app._snap_lock:
            pair = (*app.state, *app._fields)
        snaps.append((pair, [t.clone() for t in pair]))
    app.terminate()
    assert app.updates_published == app._jobs_submitted + 1 == 4
    assert [sorted(u) for u in app.update_ms[1:]] == [
        ["clone", "fields", "fusion"]] * 3, app.update_ms
    for pair, copy in snaps:
        for t, c in zip(pair, copy):
            assert torch.equal(t, c)
    assert not torch.equal(snaps[0][0][1], snaps[-1][0][1])


@pytest.mark.parametrize("world", [2, 4])
def test_k1_per_slab_matches_plain(cuda, world):
    """The sharded projective fusion runs K1 on each rank's x-slab with the
    slab's own coordinates: every slab equals the plain sweep's rows of
    the whole window (level and tilted).  The ranks are laid out without a
    group: fusion needs no communication."""
    from warpsense_tpu_torch.parallel.sharded import (Mesh, shard_state,
                                                      slab_rows,
                                                      tsdf_update_projective_sharded)
    size = (160, 150, 60)
    kw = dict(size=size, tau=TAU, max_weight=32 * 64, resolution=RES,
              channels=128, columns=1024, vfov_deg=45.0)
    pts = torch.as_tensor(box_room_cloud(20000, 4300, 1500), device=cuda)
    mask = torch.ones(len(pts), dtype=torch.bool, device=cuda)
    spos = torch.tensor([1, -1, 0], dtype=torch.int32, device=cuda)
    for R, level in ((torch.eye(3), True), (_tilt(6.0), False)):
        whole = create_state(size, TAU, 0, force_odd=False)
        plain = clone_state(whole)
        sweep_kw = dict(tau=TAU, resolution=RES, channels=128,
                        columns=1024, vfov_deg=45.0)
        rng_tab, ends, smm, cx, cy, cz = fusion_inputs(
            plain, pts.cpu(), mask.cpu(), spos.cpu(), R, size=size,
            **sweep_kw)
        sweep_merge_plain(plain.value, plain.weight, cx, cy, cz, rng_tab,
                          ends, smm, R, max_weight=32 * 64, **sweep_kw)
        before = fusion_sweep_merge.launches
        for rank in range(world):
            mesh = Mesh(None, rank, world, cuda)
            lo, hi = slab_rows(mesh, size[0])
            st = tsdf_update_projective_sharded(
                shard_state(whole, mesh), pts, mask, spos, R, mesh=mesh,
                level=level, **kw)
            assert torch.equal(st.value.cpu(), plain.value[lo:hi])
            assert torch.equal(st.weight.cpu(), plain.weight[lo:hi])
        assert fusion_sweep_merge.launches == before + world
        assert int((plain.weight != 0).sum()) > 100_000


@pytest.mark.parametrize("exact", [False, True])
def test_k2_on_padded_slabs_matches_whole_window(cuda, exact):
    """K2 on each slab padded with its ring neighbours' edge planes, outer
    planes dropped, gives the whole window's planes (and the plain
    version's) bit for bit."""
    from warpsense_tpu_torch.map.local_map import LocalMapState
    size, world = (64, 45, 37), 4
    g = torch.Generator().manual_seed(7)
    value = torch.randint(-32768, 32767, size, generator=g,
                          dtype=torch.int32).to(torch.int16)
    weight = torch.where(torch.rand(size, generator=g) < 0.7,
                         torch.randint(1, 32767, size, generator=g,
                                       dtype=torch.int32),
                         torch.zeros(size, dtype=torch.int32)).to(torch.int16)
    pos = torch.zeros(3, dtype=torch.int32)
    off = torch.tensor([s // 2 for s in size], dtype=torch.int32)
    whole = LocalMapState(value.to(cuda), weight.to(cuda), pos.to(cuda),
                          off.to(cuda))
    want = fields_packed(whole, tau=1000, exact=exact)
    plain = fields_packed(LocalMapState(value, weight, pos, off), tau=1000,
                          exact=exact)
    for a, b in zip(want, plain):
        assert torch.equal(a.cpu(), b)
    xs = size[0] // world
    for r in range(world):
        lo, hi = r * xs, (r + 1) * xs
        rows = [(lo - 1) % size[0], *range(lo, hi), hi % size[0]]
        padded = LocalMapState(value[rows].to(cuda), weight[rows].to(cuda),
                               whole.pos, whole.offset)
        got = fields_packed(padded, tau=1000, exact=exact)
        for a, b in zip(got, want):
            assert torch.equal(a[1:-1], b[lo:hi])


def test_k2_parity_on_padded_slabs_and_the_sharded_caller(cuda):
    """K2's parity mode as ``register_cloud_sharded`` runs it: on each slab
    padded with its ring neighbours' edge planes, outer planes dropped, it
    gives the whole window's planes (and the plain version's) bit for bit
    on the planted full-range window; at a world of one the sharded caller
    launches it once and its pose is the single-window registration's."""
    from warpsense_tpu_torch.map.local_map import LocalMapState
    from warpsense_tpu_torch.parallel.sharded import (make_mesh,
                                                      register_cloud_sharded)
    size, world = (64, 45, 37), 4
    v, w = planted_window(size, 7)
    value, weight = torch.from_numpy(v), torch.from_numpy(w)
    pos = torch.zeros(3, dtype=torch.int32)
    off = torch.tensor([s // 2 for s in size], dtype=torch.int32)
    whole = LocalMapState(value.to(cuda), weight.to(cuda), pos.to(cuda),
                          off.to(cuda))
    want = fields_parity(whole)
    plain = treg.precompute_fields(LocalMapState(value, weight, pos, off))
    for a, b in zip(want, plain):
        assert torch.equal(a.cpu(), b)
    xs = size[0] // world
    for r in range(world):
        lo, hi = r * xs, (r + 1) * xs
        rows = [(lo - 1) % size[0], *range(lo, hi), hi % size[0]]
        padded = LocalMapState(value[rows].to(cuda), weight[rows].to(cuda),
                               whole.pos, whole.offset)
        got = fields_parity(padded)
        for a, b in zip(got, want):
            assert torch.equal(a[1:-1], b[lo:hi])
    g = torch.Generator().manual_seed(3)
    half = torch.tensor([(s // 2 - 2) * RES for s in size])
    pts = ((torch.rand((4000, 3), generator=g) * 2 - 1) * half).to(
        torch.int32).to(cuda)
    mask = torch.ones(len(pts), dtype=torch.bool, device=cuda)
    pose = _reg_pose(1.0, (60.0, -40.0, 20.0)).to(cuda)
    kw = dict(size=size, resolution=RES, max_iterations=8,
              it_weight_gradient=0.1, epsilon=0.03)
    launches = fields_parity.launches
    got = register_cloud_sharded(whole, pts, mask, pose,
                                 mesh=make_mesh(cuda), **kw)
    assert fields_parity.launches == launches + 1
    one = treg.register_cloud_fields(want, whole.pos, whole.offset, pts,
                                     mask, pose, **kw)
    assert torch.equal(got, one)


# ------------------------------------ registration: the loop kernel (K3, K4)
# A room fused by K1 at 81 x 81 x 65; the fast LM (coarse phase and gather
# freeze, so one loop runs every K3 mode) on K2's packed and exact fields,
# the parity GN on the plain parity fields, each one launch of the loop
# kernel, traced.  Tolerances as chip_smoke's REGLOOP: K3's sums (each
# traced iteration's rows, summed) in another order than the plain matmul
# (relative 1e-5, H and g against their largest entry; c exact), K4 the
# plain step to the bit at every traced step, the loop equal in iterations
# to the host loop and within 0.5 mm / 1e-4 rad.

REG_SIZE = (81, 81, 65)


@pytest.fixture(scope="module")
def reg_problems():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    cuda = torch.device("cuda")
    kw = dict(tau=TAU, resolution=RES, channels=64, columns=512,
              vfov_deg=90.0)
    half = min(REG_SIZE[:2]) * RES * 45 // 100
    zhalf = REG_SIZE[2] * RES * 2 // 5
    pts = torch.as_tensor(box_room_cloud(6000, half, zhalf), device=cuda)
    mask = torch.ones(len(pts), dtype=torch.bool, device=cuda)
    st = create_state(REG_SIZE, TAU, 0, device=cuda, force_odd=False)
    spos = torch.zeros(3, dtype=torch.int32, device=cuda)
    rng_tab, endpoint, smm, cx, cy, cz = fusion_inputs(
        st, pts, mask, spos, torch.eye(3), size=REG_SIZE, **kw)
    fusion_sweep_merge(st.value, st.weight, cx, cy, cz, rng_tab, endpoint,
                       smm, torch.eye(3), max_weight=2048, level=True, **kw)
    common = dict(pos=st.pos, offset=st.offset, points=pts, mask=mask,
                  size=REG_SIZE, resolution=RES, tau=TAU)
    lm = dict(common, interp=True, normalize=False, lm=True, recenter=True,
              coarse_iterations=3, split=True, max_iterations=50,
              epsilon=0.03, it_weight_gradient=0.0, freeze_step_mm=64.0)
    gn = dict(common, interp=False, normalize=False, lm=False,
              recenter=False, coarse_iterations=0, split=False,
              max_iterations=200, epsilon=0.03, it_weight_gradient=0.1,
              freeze_step_mm=0.0)
    return _reg_pose(1.0, (100.0, -100.0, 0.0)).to(cuda), {
        "packed": treg.RegProblem(fields=fields_packed(st, tau=TAU),
                                  layout=treg.LAYOUT_PACKED, **lm),
        "exact": treg.RegProblem(fields=fields_packed(st, tau=TAU,
                                                      exact=True),
                                 layout=treg.LAYOUT_EXACT, **lm),
        "parity": treg.RegProblem(fields=treg.precompute_fields(st),
                                  layout=treg.LAYOUT_PARITY, **gn)}


def _reg_pose(deg, t):
    """A rotation of ``deg`` about (1, 1, 1) and a translation ``t`` mm."""
    pose = torch.eye(4)
    a = math.radians(deg) / math.sqrt(3.0)
    K = torch.tensor([[0.0, -a, a], [a, 0.0, -a], [-a, a, 0.0]])
    pose[:3, :3] = torch.linalg.matrix_exp(K)
    pose[:3, 3] = torch.tensor(t)
    return pose


# from here the fast LM's steps fall below the freeze (64 mm, 1e-3 rad)
# before it stops, so its last iterations run from the gathered cache (the
# plain loop on the CPU: frozen from the sixth step of seven)
FREEZE_POSE = (0.2, (30.0, -20.0, 10.0))


def _traced(prob, pose):
    """One launch of the loop kernel from ``pose`` with a trace: (end
    state, trace)."""
    from warpsense_tpu_torch.kernels import registration as kreg
    st = treg.init_state(prob, pose, pose.device)
    trace = torch.zeros((prob.max_iterations, kreg.TRACE_WIDTH),
                        device=pose.device)
    launches = kreg.reg_loop.launches
    kreg.reg_loop(st, prob, trace=trace)
    torch.cuda.synchronize()
    assert kreg.reg_loop.launches == launches + 1
    return st, trace


def _full(prob):
    return prob._replace(coarse_iterations=0, split=False)


def _check_traced_stats(prob, st, trace):
    """Each traced iteration's rows, summed, against the plain statistics
    at the traced carry (``ops/registration.trace_stats``): c equal and
    H / g / e within 1e-5 relative; the modes the run went through."""
    its = treg.trace_stats(trace, int(st[treg.S_I]), prob)
    for k, r in enumerate(its):
        assert r["c"] == r["c_plain"] and r["c"] > 100, (k, r)
        assert max(r["H_rel"], r["g_rel"], r["e_rel"]) <= 1e-5, (k, r)
    return {r["mode"] for r in its}


@pytest.mark.parametrize("name", ["packed", "exact", "parity"])
def test_k3_matches_plain_in_every_mode(reg_problems, name):
    """Each traced iteration's statistics against the plain version's in
    every mode the layout runs; a second launch traces the same bits."""
    pose, probs = reg_problems
    runs = [(_full(probs[name]), pose)]
    if name != "parity":
        runs.append((probs[name], _reg_pose(*FREEZE_POSE).to(pose.device)))
    modes = set()
    for prob, start in runs:
        st, trace = _traced(prob, start)
        st2, trace2 = _traced(prob, start)
        assert torch.equal(st, st2) and torch.equal(trace, trace2)
        modes |= _check_traced_stats(prob, st, trace)
    assert modes == ({"full"} if name == "parity"
                     else {"full", "coarse", "gather", "cached"}), modes


@pytest.mark.parametrize("name", ["packed", "parity"])
def test_loop_kernel_at_a_resolution_that_is_no_power_of_two(reg_problems,
                                                             name):
    """The cell's floor division and the gradient's division by the
    resolution take their general path (the fast path is a shift and a
    product with the exact reciprocal of a power of two): the same checks
    at 60 mm (the cloud then reads other cells of the same planes)."""
    pose, probs = reg_problems
    prob = probs[name]._replace(resolution=60, normalize=True)
    st, trace = _traced(prob, pose)
    _check_traced_stats(prob, st, trace)
    assert treg.replay_trace(trace, st, prob)[1] == []


@pytest.mark.parametrize("name", ["packed", "exact", "parity"])
def test_k4_matches_plain_along_a_registration(reg_problems, name):
    """Every traced step of the loop kernel is the plain step's to the
    bit: ``reg_step_plain`` from each traced carry on the traced rows gives
    the next traced carry, and after the last the kernel's end state."""
    pose, probs = reg_problems
    st, trace = _traced(probs[name], pose)
    _, differ, tests, err = treg.replay_trace(trace, st, probs[name])
    assert differ == [] and err == 0.0 and len(tests) > 2


@pytest.mark.parametrize("name", ["packed", "exact", "parity"])
def test_device_loop_matches_host_loop(reg_problems, name):
    """A registration on the card is one launch and one read of the
    header, at the host loop's iterations and within 0.5 mm / 1e-4 rad."""
    from warpsense_tpu_torch.kernels.registration import reg_loop
    pose, probs = reg_problems
    prob = probs[name]
    at = treg.S_ACC if prob.lm else treg.S_TRIAL
    launches = reg_loop.launches
    syncs = treg.run_registration.syncs
    dev, head = treg.run_registration(prob, pose)
    assert treg.run_registration.syncs - syncs == 1
    assert reg_loop.launches - launches == 1
    n = int(head[treg.S_I])
    host, hhead = treg.run_registration(prob, pose, host=True)
    assert int(hhead[treg.S_I]) == n
    a = dev[at:at + 16].reshape(4, 4).cpu().double()
    b = host[at:at + 16].reshape(4, 4).double()
    assert (a[:3, 3] - b[:3, 3]).abs().max() < 0.5
    assert (a[:3, :3].T @ b[:3, :3] - torch.eye(3, dtype=torch.float64)
            ).abs().max() < 1e-4
    assert (a[:3, 3] - pose[:3, 3].cpu()).abs().max() > 5.0   # it moved


def test_loop_kernel_places_its_cluster(reg_problems):
    """The library is built for the wrapper's cluster, which the card
    places for every layout; the empty cluster loop runs on that cluster
    and reads every CTA's row."""
    from warpsense_tpu_torch.kernels import registration as kreg
    pose, _ = reg_problems
    assert kreg._lib().ws_reg_cluster() == kreg.CLUSTER == 16
    for layout in (treg.LAYOUT_PARITY, treg.LAYOUT_PACKED,
                   treg.LAYOUT_EXACT):
        assert kreg.max_clusters(layout) >= 1
    out = torch.zeros(32, device=pose.device)
    kreg.launch_cluster_empty(out, 10)
    torch.cuda.synchronize()
    # the last iteration's rows hold 9 + column in every CTA
    assert torch.equal(out, kreg.CLUSTER * (9.0 + torch.arange(
        32, device=out.device, dtype=torch.float32)))


# ------------------------- registration: the sharded loop (one launch an
# iteration)
# The same problems cut into x-slabs of the window, as the ranks of a mesh
# hold them (``RegProblem.x_lo``, ``x_rows``; the fields are the slab's
# rows).  A world is simulated in one process: each rank launches
# ``shard_iter_kernel`` (the step on the rows gathered last, then its
# slab's statistics into its rows), then every rank's rows are copied into
# its place of one shared (2, world * 16, 32) buffer (the gather).
# Tolerances: each rank's rows, summed, against ``reg_stats_plain`` on its
# slab as REGLOOP's (relative 1e-5, c exact); a world of one is the loop
# kernel's registration to the bit; every rank's carry the same bits;
# every traced step the plain step's bits.

def _slab(prob, lo, hi):
    """``prob`` on the window's rows [lo, hi): the fields' rows, owned."""
    return prob._replace(fields=type(prob.fields)(*(p[lo:hi]
                                                    for p in prob.fields)),
                         x_lo=lo, x_rows=hi - lo)


def _simulated_world(prob, pose, world, traced=True):
    """One registration of ``prob`` over ``world`` simulated ranks (slabs
    [r X / world, (r + 1) X / world)): (each rank's end state, each
    rank's trace, each rank's slab problem)."""
    from warpsense_tpu_torch.kernels import registration as kreg
    X = prob.size[0]
    k = kreg.CLUSTER
    shared = torch.zeros((2, world * k, treg.PARTIALS), device=pose.device)
    ranks = []
    for r in range(world):
        sp = _slab(prob, r * X // world, (r + 1) * X // world)
        bufs = kreg.shard_buffers(pose.device, world)._replace(
            rows_all=shared)
        treg.init_state(sp, pose, pose.device,
                        out=bufs.carry[0, :treg.STATE_LEN])
        trace = torch.zeros((prob.max_iterations, treg.trace_width(world * k)),
                            device=pose.device) if traced else None
        ranks.append((bufs, trace, sp, kreg.shard_plan(bufs, sp,
                                                       trace=trace)))
    parity = 0
    while not treg.stopped(ranks[0][0].carry[parity, :treg.STATE_LEN], prob):
        for _ in range(treg.CHUNK):
            for *_, plan in ranks:
                kreg.shard_iter(plan, parity)
            for r, (bufs, *_) in enumerate(ranks):
                shared[1 - parity, r * k:(r + 1) * k].copy_(
                    bufs.rows[1 - parity])
            parity ^= 1
    torch.cuda.synchronize()
    return ([r[0].carry[parity, :treg.STATE_LEN].clone() for r in ranks],
            [r[1] for r in ranks], [r[2] for r in ranks])


def _check_rank_stats(trace, n, slabs):
    """Each traced iteration's rows of each rank, summed in the step's
    order, against ``reg_stats_plain`` on its slab at the traced carry
    (each rank's cache gathered where the loop's was): c equal, H / g / e
    within 1e-5 relative.  Returns the modes run."""
    from warpsense_tpu_torch.kernels.registration import CLUSTER
    host = trace[:n].cpu()
    caches = [{} for _ in slabs]
    modes = set()
    for i in range(n):
        carry = trace[i, :treg.STATE_LEN].clone()
        prob = slabs[0]
        if prob.lm and i < prob.coarse_iterations:
            modes.add("coarse")
        elif prob.split:
            modes.add("cached" if bool(host[i, treg.S_FROZEN]) else "gather")
        else:
            modes.add("full")
        rows = host[i, treg.STATE_LEN:].reshape(-1, treg.PARTIALS)
        for r, (sp, cache) in enumerate(zip(slabs, caches)):
            got = treg.sum_partials(rows[r * CLUSTER:(r + 1) * CLUSTER])
            want = treg.reg_stats_plain(carry, sp, cache)[0].cpu()
            assert got[28] == want[28], (i, r, float(got[28]),
                                         float(want[28]))
            for lo, hi in ((0, 21), (21, 27), (27, 28)):
                d = (got[lo:hi].double() - want[lo:hi].double()).abs().max()
                assert d <= 1e-5 * max(float(want[lo:hi].abs().max()),
                                       1e-30), (i, r, lo)
    return modes


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("name", ["packed", "exact", "parity"])
def test_shard_stats_matches_plain_on_each_slab(reg_problems, name, world):
    """``shard_iter_kernel``'s rows on each rank's slab against the plain
    statistics on that slab, in every mode the layout runs; a second run
    traces the same bits."""
    pose, probs = reg_problems
    runs = [(_full(probs[name]), pose)]
    if name != "parity":
        runs.append((probs[name], _reg_pose(*FREEZE_POSE).to(pose.device)))
    modes = set()
    for prob, start in runs:
        states, traces, slabs = _simulated_world(prob, start, world)
        again, traces2, _ = _simulated_world(prob, start, world)
        assert torch.equal(states[0], again[0])
        assert torch.equal(traces[0], traces2[0])
        modes |= _check_rank_stats(traces[0], int(states[0][treg.S_I]),
                                   slabs)
    assert modes == ({"full"} if name == "parity"
                     else {"full", "coarse", "gather", "cached"}), modes


@pytest.mark.parametrize("name", ["packed", "exact", "parity"])
def test_sharded_loop_at_a_world_of_one_is_the_loop_kernel(reg_problems,
                                                           name):
    """``run_registration_sharded`` without a group: the loop kernel's
    registration to the bit (end state, header, every traced carry and
    row), its kernel launched once an iteration of each chunk, the header
    read once a chunk (``shard_reads``), alike from a fresh mesh's first
    registration (launched from the host) and the later ones (its
    captured chunk, replayed)."""
    from warpsense_tpu_torch.kernels import registration as kreg
    from warpsense_tpu_torch.parallel.sharded import (
        make_mesh, run_registration_sharded)
    pose, probs = reg_problems
    for prob, start in ((probs[name], pose),
                        (probs[name], _reg_pose(*FREEZE_POSE).to(
                            pose.device))):
        st, trace = _traced(prob, start)
        mesh = make_mesh("cuda")
        for replayed in (False, True, True):
            strace = torch.zeros_like(trace)
            counts = (kreg.shard_iter.launches, treg.run_registration.syncs,
                      kreg.shard_iter.replays)
            got, head = run_registration_sharded(
                prob, start, mesh, trace=strace)
            reads = treg.shard_reads(int(head[treg.S_I]))
            assert (kreg.shard_iter.launches - counts[0],
                    treg.run_registration.syncs - counts[1],
                    kreg.shard_iter.replays - counts[2]) == (
                reads * treg.CHUNK, reads, reads if replayed else 0)
            assert torch.equal(got, st) and head == st[:treg.S_HEAD].tolist()
            assert torch.equal(strace, trace)


def test_sharded_loop_with_an_odd_chunk_stays_a_host_loop(reg_problems):
    """An odd chunk cannot be captured (the carry would end in slot 1):
    every registration at chunk 3, the second of its kind too, launches
    from the host, one launch an iteration, and gives the loop kernel's
    bits."""
    from warpsense_tpu_torch.kernels import registration as kreg
    from warpsense_tpu_torch.parallel.sharded import (
        make_mesh, run_registration_sharded)
    pose, probs = reg_problems
    prob = probs["packed"]
    st, _ = _traced(prob, pose)
    mesh = make_mesh("cuda")
    before = (kreg.shard_iter.replays, kreg.shard_iter.captures)
    for _ in range(2):
        launches = kreg.shard_iter.launches
        got, head = run_registration_sharded(prob, pose, mesh, chunk=3)
        reads = treg.shard_reads(int(head[treg.S_I]), 3)
        assert kreg.shard_iter.launches - launches == 3 * reads
        assert torch.equal(got, st) and head == st[:treg.S_HEAD].tolist()
    assert (kreg.shard_iter.replays, kreg.shard_iter.captures) == before


def test_fused_kernel_matches_its_plain_version(reg_problems):
    """One launch of ``shard_iter_kernel`` against ``fused_iteration_plain``
    on the same carry slot and rows, at every traced carry of a
    registration on a slab of half the window: the new carry (the step)
    to the bit, PENDING set, the rows' sum within 1e-5 relative (c
    exact); the slot read and the rows read stay as they were (the
    double buffer); a stopped carry is copied with PENDING clear and no
    rows written."""
    from warpsense_tpu_torch.kernels import registration as kreg
    pose, probs = reg_problems
    for name in ("packed", "parity"):
        prob = probs[name]
        X = prob.size[0]
        sp = _slab(prob, 0, X // 2)
        states, traces, _ = _simulated_world(prob, pose, 2)
        n = int(states[0][treg.S_I])
        bufs = kreg.shard_buffers(pose.device, 1, shared=True)
        plan = kreg.shard_plan(bufs, sp)
        host = sp._replace(fields=type(sp.fields)(
            *(f.cpu() for f in sp.fields)), pos=sp.pos.cpu(),
            offset=sp.offset.cpu(), points=sp.points.cpu(),
            mask=sp.mask.cpu())
        cache: dict = {}
        for i in range(1, n):
            for parity in (0, 1):
                src = torch.zeros(treg.CARRY_LEN, device=pose.device)
                src[:treg.STATE_LEN] = traces[0][i - 1, :treg.STATE_LEN]
                src[treg.PENDING] = 1.0
                rows_in = traces[0][i - 1, treg.STATE_LEN:].reshape(
                    -1, treg.PARTIALS)[:kreg.CLUSTER]
                bufs.carry[parity].copy_(src)
                bufs.rows[parity].copy_(rows_in)
                bufs.carry[1 - parity].fill_(-1.0)
                kreg.shard_iter(plan, parity)
                torch.cuda.synchronize()
                assert torch.equal(bufs.carry[parity], src)
                assert torch.equal(bufs.rows[parity], rows_in)
                want_src = src.cpu()
                want_dst = torch.full((treg.CARRY_LEN,), -1.0)
                want_rows = torch.zeros((1, treg.PARTIALS))
                treg.fused_iteration_plain(want_src, want_dst, rows_in.cpu(),
                                           want_rows, host, cache)
                got = bufs.carry[1 - parity].cpu()
                assert torch.equal(got[:treg.PENDING + 1],
                                   want_dst[:treg.PENDING + 1]), (name, i)
                if bool(want_dst[treg.PENDING]):
                    row = treg.sum_partials(bufs.rows[1 - parity]).cpu()
                    assert row[28] == want_rows[0, 28]
                    for lo, hi in ((0, 21), (21, 27), (27, 28)):
                        d = (row[lo:hi].double()
                             - want_rows[0, lo:hi].double()).abs().max()
                        assert d <= 1e-5 * max(float(
                            want_rows[0, lo:hi].abs().max()), 1e-30)
        stop = bufs.carry[0].clone()
        stop[treg.S_FIN] = 1.0
        stop[treg.PENDING] = 0.0
        bufs.carry[0].copy_(stop)
        kept = bufs.rows.clone()
        kreg.shard_iter(plan, 0)
        torch.cuda.synchronize()
        assert torch.equal(bufs.carry[1, :treg.STATE_LEN],
                           stop[:treg.STATE_LEN])
        assert bufs.carry[1, treg.PENDING] == 0.0
        assert torch.equal(bufs.rows, kept)


def test_one_launch_an_iteration(reg_problems):
    """The sharded loop at a world of one launches ``shard_iter_kernel``
    once an iteration of every chunk and no loop kernel: a fresh mesh's
    first registration from the host, CHUNK launches a header read and no
    replay; the next ones from the captured chunk, one replay a header
    read, the chunk captured once for every registration of its kind."""
    from warpsense_tpu_torch.kernels import registration as kreg
    from warpsense_tpu_torch.parallel.sharded import (
        make_mesh, run_registration_sharded)
    pose, probs = reg_problems
    prob = probs["packed"]
    mesh = make_mesh("cuda")
    captures = kreg.shard_iter.captures
    for runs, replayed in ((1, False), (3, True)):
        before = (kreg.shard_iter.launches, kreg.shard_iter.replays,
                  kreg.reg_loop.launches, treg.run_registration.syncs)
        for _ in range(runs):
            _, head = run_registration_sharded(prob, pose, mesh)
        reads = runs * treg.shard_reads(int(head[treg.S_I]))
        assert (kreg.shard_iter.launches - before[0],
                kreg.shard_iter.replays - before[1],
                kreg.reg_loop.launches - before[2],
                treg.run_registration.syncs - before[3]) == (
            reads * treg.CHUNK, reads if replayed else 0, 0, reads)
        assert kreg.shard_iter.captures - captures == int(replayed)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["packed", "exact", "parity"])
def test_sharded_steps_are_the_plain_step_on_every_rank(reg_problems, name,
                                                        world):
    """Every simulated rank ends on the same carry and traces the same
    bits; every traced step, replayed by ``reg_step_plain`` on the world's
    rows, gives the next traced carry to the bit; the pose within 0.5 mm
    and 1e-4 rad of the loop kernel's on the whole window."""
    pose, probs = reg_problems
    prob = probs[name]
    states, traces, _ = _simulated_world(prob, pose, world)
    for st, tr in zip(states[1:], traces[1:]):
        assert torch.equal(st, states[0]) and torch.equal(tr, traces[0])
    _, differ, tests, err = treg.replay_trace(traces[0], states[0], prob)
    assert differ == [] and err == 0.0 and len(tests) > 2
    at = treg.S_ACC if prob.lm else treg.S_TRIAL
    whole, _ = _traced(prob, pose)
    a = states[0][at:at + 16].reshape(4, 4).cpu().double()
    b = whole[at:at + 16].reshape(4, 4).cpu().double()
    assert (a[:3, 3] - b[:3, 3]).abs().max() < 0.5
    assert (a[:3, :3].T @ b[:3, :3] - torch.eye(3, dtype=torch.float64)
            ).abs().max() < 1e-4


def test_sharded_kernels_raise_on_a_failed_launch(reg_problems, monkeypatch):
    """Arguments the library refuses (an unknown layout) and a launch that
    fails raise, launched from the host or captured; nothing falls back
    to the plain versions and the launch counts stay."""
    from warpsense_tpu_torch.kernels import registration as kreg
    from warpsense_tpu_torch.parallel.sharded import (
        make_mesh, run_registration_sharded)
    pose, probs = reg_problems
    prob = probs["packed"]
    bufs = kreg.shard_buffers(pose.device, 1, shared=True)
    with pytest.raises(RuntimeError, match="arguments"):
        kreg.shard_plan(bufs, prob._replace(layout=7))
    cold, warm = make_mesh("cuda"), make_mesh("cuda")
    run_registration_sharded(prob, pose, warm)    # warm, not captured
    lib = kreg._lib()

    class Failing:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def ws_reg_shard_iter(args, layout, parity, stream):
            return 700          # cudaErrorIllegalAddress

    monkeypatch.setattr(kreg, "_lib", lambda: Failing())
    launches = (kreg.shard_iter.launches, kreg.shard_iter.replays)
    for mesh in (cold, warm):       # launched from the host; captured
        with pytest.raises(RuntimeError, match="sharded iteration"):
            run_registration_sharded(prob, pose, mesh)
    assert (kreg.shard_iter.launches, kreg.shard_iter.replays) == launches


def test_sharded_app_monitor_on_cuda_is_the_single_gpu_apps(cuda):
    """The sharded app at a world of one (no group) with a live monitor on
    the card publishes, scan by scan, the single-GPU app's map snapshots
    (period 0: every scan), path and status, bit for bit."""
    from warpsense_tpu_torch.obs.live import LiveMonitor
    from warpsense_tpu_torch.parallel.sharded import make_mesh
    from warpsense_tpu_torch.pipeline.warpsense_sharded import \
        ShardedWarpsenseApp
    params = Params.from_dict({
        "map": {"max_distance": 0.6, "resolution": 128, "max_weight": 10,
                "size": {"x": 12, "y": 10, "z": 6}, "shift": 0.18,
                "update_distance": 0.05},
        "registration": {"max_iterations": 20, "epsilon": 0.03,
                         "it_weight_gradient": 0.1, "mode": "fast"},
        "lidar": {"channels": 16, "hresolution": 128}})
    scans = _walk_scans(6, 16, 128)
    kw = dict(in_memory_map=True, capacity=2048, window_size=(96, 79, 47),
              sync_shift=True)
    runs = []
    for sharded in (True, False):
        mon = LiveMonitor(map_snapshot_period_s=0.0)
        snaps, shifts = [], []
        mon.subscribe("map", lambda s: snaps.append(
            [np.asarray(x.cpu() if torch.is_tensor(x) else x) for x in s]))
        mon.subscribe("shift", lambda pos: shifts.append(np.asarray(pos)))
        app = (ShardedWarpsenseApp(params, mesh=make_mesh(cuda), monitor=mon,
                                   **kw) if sharded else
               WarpsenseApp(params, force_odd=False,
                            fusion="projective-level", device=cuda,
                            monitor=mon, **kw))
        poses = np.stack([app.cloud_callback(s, 0.1 * i)
                          for i, s in enumerate(scans)])
        app.terminate()
        runs.append((poses, mon, snaps, shifts))
    (poses, mon, snaps, shifts), (want, one, one_snaps, one_shifts) = runs
    np.testing.assert_array_equal(poses, want)
    assert len(snaps) == len(one_snaps) == len(scans)
    for a, b in zip(snaps, one_snaps):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert shifts and len(shifts) == len(one_shifts)
    for a, b in zip(shifts, one_shifts):
        np.testing.assert_array_equal(a, b)
    assert mon.tum_path() == one.tum_path()
    for k in ("scans", "map_epoch", "shifts", "last_shift_pos"):
        assert mon.status[k] == one.status[k], k


def test_offline_clis_on_cuda_match_cpu(cuda, monkeypatch):
    """eval.pcd2tsdf and eval.pcd_registration at their CLI defaults on the
    card against the same calls on the CPU (chip_smoke's OFFLINE bounds):
    the ray march's volumes equal bit for bit and the host twin's exact
    agreement 1.0; idle below 20 mm, each registration one launch of the
    loop kernel, and each case the CPU run recovers (below 120 mm) within
    1 mm of it.  The translation cases are recovered by neither package at
    these defaults: after 200 iterations the card and the CPU part by
    ~90 mm there."""
    from warpsense_tpu_torch.eval import pcd2tsdf, pcd_registration
    from warpsense_tpu_torch.kernels.registration import reg_loop
    volume, volumes = pcd2tsdf.tsdf_volume, []

    def kept(*a, **kw):
        state, ms = volume(*a, **kw)
        volumes.append(state)
        return state, ms
    monkeypatch.setattr(pcd2tsdf, "tsdf_volume", kept)
    out = {}
    for dev in ("cuda", "cpu"):
        launches = reg_loop.launches
        out[dev] = (pcd2tsdf.main(["--device", dev]),
                    pcd_registration.main(["--device", dev]),
                    reg_loop.launches - launches)
    (card, card_reg, card_launches), (cpu, cpu_reg, cpu_launches) = \
        out["cuda"], out["cpu"]
    assert card["exact_agreement"] == cpu["exact_agreement"] == 1.0
    assert card["touched_voxels_device"] == cpu["touched_voxels_device"] > 0
    assert len(volumes) == 6
    for a, b in zip(volumes[:3], volumes[3:]):
        assert torch.equal(a.value.cpu(), b.value)
        assert torch.equal(a.weight.cpu(), b.weight)
    assert (card_launches, cpu_launches) == (len(card_reg), 0)
    assert card_reg["idle"]["avg"] < 20.0
    recovered = [k for k, v in cpu_reg.items() if v["avg"] < 120.0]
    assert len(recovered) == 3, cpu_reg
    for name in recovered:
        got = card_reg[name]
        assert abs(got["avg"] - cpu_reg[name]["avg"]) <= 1.0, (
            name, got, cpu_reg[name])
