"""CUDA kernels K1 (fusion) and K2 (fields) against their plain PyTorch
versions on the card.  A CUDA kernel has no CPU mode, so every test here
needs a GPU and skips without one.  This file imports no JAX (the GPU
machine has none); run it there without the JAX conftest:

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
from warpsense_tpu_torch.ops.tsdf_projective import (fusion_inputs,
                                                     sweep_merge_plain)
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


@pytest.mark.parametrize("size", [(37, 29, 23), (64, 40, 33)])
@pytest.mark.parametrize("exact", [False, True])
def test_fields_kernel_matches_plain(cuda, size, exact):
    rng = np.random.default_rng(sum(size))
    v = rng.integers(-TAU, TAU + 1, size).astype(np.int16)
    w = ((rng.random(size) < 0.7) * rng.integers(1, 64, size)).astype(
        np.int16)
    st = create_state(size, TAU, 0, device=cuda, force_odd=False)
    st.value.copy_(torch.as_tensor(v))
    st.weight.copy_(torch.as_tensor(w))
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
