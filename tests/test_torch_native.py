"""Port vs JAX: the native host runtime (``native/``, built with g++):
the ring buffer and the typed scan queue, the preprocessing twin and the
shift's slab copies, mirroring tests/test_native.py.

Exact throughout: the queue returns the bytes pushed, ``preprocess_host``
gives JAX's voxel set, and the slab copies give the numpy twin's window
and global map, and JAX's ``LocalMap``'s, byte for byte.  A failed build
raises.
"""
import threading

import numpy as np
import pytest

from warpsense_tpu.map.global_map import GlobalMap as JGlobalMap
from warpsense_tpu.map.local_map import LocalMap as JLocalMap
from warpsense_tpu.ops.preprocess import preprocess_host as jpreprocess_host
from warpsense_tpu_torch import native
from warpsense_tpu_torch.map.global_map import GlobalMap
from warpsense_tpu_torch.map.local_map import LocalMap
from warpsense_tpu_torch.ops.preprocess import preprocess_host
from warpsense_tpu_torch.utils.native_queue import NativeByteQueue, ScanQueue


def test_version_and_the_same_source_as_jax():
    assert native.load().ws_version() == 1
    from warpsense_tpu import native as jnative
    body = native.SRC.read_text()
    jbody = jnative._SRC.read_text()
    # the same code after the header comment
    cut = body.index("#include <atomic>")
    assert body[cut:] == jbody[jbody.index("#include <atomic>"):]


def test_byte_queue_fifo_and_force():
    q = NativeByteQueue(2)
    assert q.push(b"a") and q.push(b"b")
    assert not q.push(b"c")                  # full, non-blocking
    assert q.push(b"c", force=True)          # drops the oldest
    assert q.pop() == b"b"
    assert q.pop() == b"c"
    assert q.pop() is None
    assert len(q) == 0
    q.push(b"x" * 100)
    assert q.pop(max_bytes=8) == b"x" * 100  # larger than the buffer
    q.push(b"y")
    q.clear()
    assert len(q) == 0


def test_byte_queue_blocking_producer_consumer():
    q = NativeByteQueue(4)
    got = []

    def consumer():
        while True:
            item = q.pop(timeout=2.0)
            if item == b"STOP":
                break
            got.append(item)

    t = threading.Thread(target=consumer)
    t.start()
    for i in range(50):
        assert q.push(f"item{i}".encode(), timeout=2.0)
    q.push(b"STOP", timeout=2.0)
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert got == [f"item{i}".encode() for i in range(50)]


@pytest.mark.parametrize("backend", ["native", "python"])
def test_scan_queue_roundtrip(backend):
    q = ScanQueue(2, backend=backend)
    assert q.backend == backend
    cloud = np.random.default_rng(0).normal(0, 1, (8, 16, 3)).astype(
        np.float32)
    assert q.push(1.5, cloud, timeout=1.0)
    assert q.push(2.5, cloud[:3], timeout=1.0)
    assert not q.push(3.5, cloud)            # full, non-blocking
    assert q.push(3.5, cloud[1], force=True)
    assert len(q) == 2
    stamp, got = q.pop(timeout=1.0)
    assert stamp == 2.5
    np.testing.assert_array_equal(got, cloud[:3])
    stamp, got = q.pop()
    assert stamp == 3.5 and got.shape == (16, 3)
    assert q.pop() is None
    with pytest.raises(ValueError):
        ScanQueue(2, backend="gpu")


def _cloud():
    rng = np.random.default_rng(5)
    pts = rng.uniform(-5, 5, (2000, 3)).astype(np.float32)
    # off voxel boundaries, so the float and integer snaps agree
    pts = np.round(pts, 2) + 0.007
    pts[:40] = 0.0                                   # invalid rows
    pts[40:80] = rng.uniform(-1, 0.29, (40, 3))      # near the origin
    return np.concatenate([pts, pts[100:300]])       # duplicates


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_preprocess_host_matches_jax(backend):
    cloud = _cloud()
    got = preprocess_host(cloud, resolution=64, capacity=2048,
                          backend=backend)
    want = jpreprocess_host(cloud, resolution=64, capacity=2048)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert 500 < got[1].sum() < 1960
    with pytest.raises(ValueError):
        preprocess_host(cloud, resolution=64, capacity=8, backend="gpu")


def _random_window(lm, seed=7):
    rng = np.random.default_rng(seed)
    lm.state.value[:] = rng.integers(-600, 600, lm.state.value.shape,
                                     dtype=np.int16)
    lm.state.weight[:] = rng.integers(0, 64, lm.state.weight.shape,
                                      dtype=np.int16)


def test_slab_copies_match_numpy_and_jax(tmp_path):
    """Native save/load areas give the numpy twin's and JAX's window and
    global map across multi-axis shifts and a resume."""
    maps = {}
    for name in ("native", "numpy", "jax"):
        if name == "jax":
            gm = JGlobalMap(tmp_path / f"{name}.h5", 600, 0)
            lm = JLocalMap((9, 9, 9), gm)
            assert lm._native is not None
        else:
            gm = GlobalMap(tmp_path / f"{name}.h5", 600, 0)
            lm = LocalMap((9, 9, 9), gm, slab_copies=name)
        _random_window(lm)
        for target in ([5, -3, 2], [-2, 4, -6], [0, 0, 0], [30, 0, 0]):
            lm.shift(target)
        lm.write_back()
        lm.load_window([3, -4, 1])
        maps[name] = (lm, gm)
    for name in ("numpy", "jax"):
        np.testing.assert_array_equal(maps["native"][0].state.value,
                                      maps[name][0].state.value)
        np.testing.assert_array_equal(maps["native"][0].state.weight,
                                      maps[name][0].state.weight)
    for _, gm in maps.values():
        gm.close()
    import h5py
    with h5py.File(tmp_path / "native.h5") as fa:
        for other in ("numpy", "jax"):
            with h5py.File(tmp_path / f"{other}.h5") as fb:
                assert set(fa["map"].keys()) == set(fb["map"].keys())
                for k in fa["map"]:
                    np.testing.assert_array_equal(fa["map"][k][...],
                                                  fb["map"][k][...])


def test_slab_copies_choice_is_checked():
    with pytest.raises(ValueError):
        LocalMap((9, 9, 9), GlobalMap(None, 600, 0), slab_copies="python")


def test_failed_build_raises(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" int ws_version() { return }\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build(bad, tmp_path)
    good = tmp_path / "fine.cpp"
    good.write_text("extern \"C\" int ws_version() { return 1; }\n")
    with pytest.raises(RuntimeError, match="compiler"):
        native.build(good, tmp_path, cxx=str(tmp_path / "no-such-g++"))
    assert not list(tmp_path.glob("*.so"))


def test_device_query_raises_without_a_gpu(monkeypatch):
    """device_query describes GPUs only: with none visible it raises."""
    import torch

    from warpsense_tpu_torch.utils import device_query
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        device_query.main([])
