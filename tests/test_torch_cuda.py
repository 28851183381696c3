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
from warpsense_tpu_torch.kernels.fields import fields_packed
from warpsense_tpu_torch.kernels.fusion import fusion_sweep_merge
from warpsense_tpu_torch.map.local_map import clone_state, create_state
from warpsense_tpu_torch.ops import registration as treg
from warpsense_tpu_torch.ops.tsdf import plan_raymarch
from warpsense_tpu_torch.ops.tsdf_projective import (fusion_inputs,
                                                     sweep_merge_plain)
from warpsense_tpu_torch.pipeline.featsense import FeatsenseApp
from warpsense_tpu_torch.pipeline.fusion_backend import fuse_cloud
from warpsense_tpu_torch.pipeline.warpsense import WarpsenseApp

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


# degenerate extents (1 and 2, where x-1 == x+1), Y*Z a multiple of 8,
# Y*Z above one tile with Z at the default extent, odd windows, and planes
# that start `offset` int16 past a 16-byte boundary (a window cut from a
# larger one starts so)
@pytest.mark.parametrize("size,offset", [
    ((37, 29, 23), 0), ((64, 40, 33), 0), ((1, 5, 7), 0), ((2, 3, 1), 0),
    ((5, 7, 3), 0), ((9, 16, 32), 0), ((3, 40, 391), 0), ((5, 13, 23), 1),
    ((5, 13, 23), 3), ((5, 13, 23), 7)])
@pytest.mark.parametrize("exact", [False, True])
def test_fields_kernel_matches_plain(cuda, size, offset, exact):
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
    before = fields_packed.launches
    got = fields_packed(st, tau=TAU, exact=exact)
    assert fields_packed.launches == before + 1
    want = (treg.precompute_fields_packed2(st) if exact
            else treg.precompute_fields_packed(st, tau=TAU))
    for g, p in zip(got, want):
        assert torch.equal(g, p)


def test_wrappers_reject_bad_inputs(cuda):
    st = create_state((8, 8, 8), TAU, 0, device=cuda)
    bad = st._replace(value=st.value.to(torch.int32))
    with pytest.raises(TypeError):
        fields_packed(bad, tau=TAU)
    strided = st._replace(value=st.value.transpose(0, 2))
    with pytest.raises(ValueError):
        fields_packed(strided, tau=TAU)
    # planes at different offsets from a 16-byte boundary: the kernel
    # stages value and weight by the same 16-byte copies
    n = st.value.numel()
    flat_v = torch.zeros(n + 8, dtype=torch.int16, device=cuda)
    flat_w = torch.zeros(n + 8, dtype=torch.int16, device=cuda)
    for ov, ow in ((1, 0), (0, 3), (2, 5)):
        skewed = st._replace(value=flat_v[ov:ov + n].view(st.value.shape),
                             weight=flat_w[ow:ow + n].view(st.value.shape))
        with pytest.raises(ValueError, match="16-byte"):
            fields_packed(skewed, tau=TAU)
    tall = create_state((1, 1, 200_000), TAU, 0, device=cuda,
                        force_odd=False)
    with pytest.raises(ValueError, match="z extent"):
        fields_packed(tall, tau=TAU)


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
    """Parity mode (fields and GN in plain PyTorch, fusion through K1): the
    card and the CPU agree on the first scans; later ones drift apart as
    the GN's float32 sums run in another order (bound 20 mm)."""
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
        f0 = fusion_sweep_merge.launches
        poses[dev] = np.stack([app.cloud_callback(s, 0.1 * i)
                               for i, s in enumerate(scans)])
        launched = fusion_sweep_merge.launches - f0
        app.terminate()
        assert (launched > 0) == (dev == "cuda")
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
