"""Port vs JAX: the original-F-LOAM twin (``frontends/featsense/
floam_original``), the feature stage's host twin (``features_reference``)
and ``eval/feature_compare``, on synthetic organized scans.

Exact: the F-LOAM picks and the host twin's picks are JAX's index for
index, and feature_compare's counts, Jaccard indices and recalls are
op-by-op JAX's (the port's feature stage follows op-by-op JAX,
tests/test_torch_featsense.py).
"""
import numpy as np
import pytest

from warpsense_tpu.eval import feature_compare as jfc
from warpsense_tpu.frontends.featsense import features_reference as jref
from warpsense_tpu.frontends.featsense.floam_original import \
    floam_original_features as jfloam
from warpsense_tpu_torch.eval import feature_compare as tfc
from warpsense_tpu_torch.frontends.featsense import features_reference as tref
from warpsense_tpu_torch.frontends.featsense.floam_original import \
    floam_original_features as tfloam


@pytest.fixture(scope="module")
def scan():
    return tfc.synthetic_scan(64, 512)


@pytest.mark.parametrize("channels,columns,seed", [(64, 512, 0),
                                                   (128, 256, 1)])
def test_floam_original_matches_jax(channels, columns, seed):
    from warpsense_tpu_torch.io.synthetic import BoxWorld, render_scan
    pose = np.eye(4)
    pose[:3, 3] = [0.3 * seed, -0.2 * seed, 0.1]
    cloud = render_scan(BoxWorld.default(), pose, channels=channels,
                        columns=columns, max_range=22.0, noise_std=0.005,
                        rng=np.random.default_rng(seed))
    e, s = tfloam(cloud.reshape(-1, 3))
    je, js = jfloam(cloud.reshape(-1, 3))
    np.testing.assert_array_equal(e, je)
    np.testing.assert_array_equal(s, js)
    assert len(e) > 0 and len(s) > len(e)


def test_host_twin_matches_jax(scan):
    got = tref.extract_features(scan, tref.FeatureParams())
    want = jref.extract_features(scan, jref.FeatureParams())
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len(got[0]) > 0 and len(got[1]) > 0


def test_feature_compare_matches_jax(scan, tmp_path):
    """Against op-by-op JAX: jitted XLA contracts the curvature's sum of
    squares into FMAs and breaks a near-tie on this scan the other way
    (tests/test_torch_featsense.py), which moves one surf pick."""
    import jax
    got = tfc.run(scan, device="cpu", out_dir=str(tmp_path / "t"))
    with jax.disable_jit():
        want = jfc.run(scan)
    for group in ("edges", "surfs"):
        assert got[group] == want[group], group
    assert got["edges"]["jaccard"] > 0.99 and got["surfs"]["jaccard"] > 0.99
    assert got["device"] == "cpu"
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == [
        "edges_device.ply", "edges_host.ply", "surfs_device.ply",
        "surfs_host.ply"]


def test_feature_compare_cli(capsys):
    import json
    report = tfc.main(["--channels", "32", "--columns", "256",
                       "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip()) == report
    assert report["edges"]["device"] == report["edges"]["host"] > 0
