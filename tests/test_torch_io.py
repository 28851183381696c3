"""Port vs JAX: the I/O layer (io/pcd, io/trajectory, io/dataset,
io/pcl_writer, io/lz4, io/rosbag).

Both packages get the same inputs, made from a numpy seed.  Files the port
writes must be byte-equal to the JAX package's, and each package must read
the other's; the ATE arithmetic is the same numpy code, so it agrees within
1e-12; decoded LZ4 bytes and bag frames must be equal."""
import bz2
import struct

import numpy as np
import pytest

from warpsense_tpu.io import dataset as jds
from warpsense_tpu.io import lz4 as jlz4
from warpsense_tpu.io import pcd as jpcd
from warpsense_tpu.io import pcl_writer as jpw
from warpsense_tpu.io import rosbag as jbag
from warpsense_tpu.io import trajectory as jtraj
from warpsense_tpu_torch.io import dataset as tds
from warpsense_tpu_torch.io import lz4 as tlz4
from warpsense_tpu_torch.io import pcd as tpcd
from warpsense_tpu_torch.io import pcl_writer as tpw
from warpsense_tpu_torch.io import rosbag as tbag
from warpsense_tpu_torch.io import trajectory as ttraj


def _cloud(n=257, c=3, seed=0):
    return np.random.default_rng(seed).normal(0, 5, (n, c)).astype(np.float32)


def _poses(n=12, seed=2):
    """Random SE(3) poses: yaw, pitch and roll, so every quaternion branch
    of mat_to_quat is taken somewhere."""
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        a, b, g = rng.uniform(-np.pi, np.pi, 3)
        rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                       [0, 0, 1]])
        ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0],
                       [-np.sin(b), 0, np.cos(b)]])
        rx = np.array([[1, 0, 0], [0, np.cos(g), -np.sin(g)],
                       [0, np.sin(g), np.cos(g)]])
        poses[i][:3, :3] = rz @ ry @ rx
        poses[i][:3, 3] = rng.uniform(-10, 10, 3)
    return poses


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("channels", [3, 4])
def test_pcd_bytes_equal_and_cross_read(tmp_path, binary, channels):
    c = _cloud(c=channels)
    tpcd.write_pcd(tmp_path / "t.pcd", c, binary=binary)
    jpcd.write_pcd(tmp_path / "j.pcd", c, binary=binary)
    assert (tmp_path / "t.pcd").read_bytes() == (tmp_path / "j.pcd").read_bytes()
    np.testing.assert_array_equal(tpcd.read_pcd(tmp_path / "j.pcd"),
                                  jpcd.read_pcd(tmp_path / "t.pcd"))
    np.testing.assert_allclose(tpcd.read_pcd(tmp_path / "j.pcd"), c,
                               atol=1e-5)


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("with_colors", [True, False])
def test_ply_bytes_equal_and_cross_read(tmp_path, binary, with_colors):
    c = _cloud(101)
    colors = (np.random.default_rng(1).uniform(0, 255, (101, 3))
              .astype(np.uint8) if with_colors else None)
    tpcd.write_ply(tmp_path / "t.ply", c, colors, binary=binary)
    jpcd.write_ply(tmp_path / "j.ply", c, colors, binary=binary)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    np.testing.assert_array_equal(tpcd.read_ply(tmp_path / "j.ply"),
                                  jpcd.read_ply(tmp_path / "t.ply"))


def test_tum_bytes_equal_and_cross_read(tmp_path):
    poses = _poses()
    stamps = np.arange(len(poses)) * 0.1 + 3.0
    ttraj.write_tum(tmp_path / "t.tum", poses, stamps, scale=1e-3)
    jtraj.write_tum(tmp_path / "j.tum", poses, stamps, scale=1e-3)
    assert (tmp_path / "t.tum").read_bytes() == (tmp_path / "j.tum").read_bytes()
    ts, tp = ttraj.read_tum(tmp_path / "j.tum")
    js, jp = jtraj.read_tum(tmp_path / "t.tum")
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tp, jp)
    expect = poses.copy()
    expect[:, :3, 3] *= 1e-3
    np.testing.assert_allclose(tp, expect, atol=1e-5)


def test_quaternions_equal_jax():
    for R in _poses(60, seed=9)[:, :3, :3]:
        np.testing.assert_array_equal(ttraj._quat_from_mat(R),
                                      jtraj._quat_from_mat(R))
        q = ttraj._quat_from_mat(R)
        np.testing.assert_array_equal(ttraj._mat_from_quat(q),
                                      jtraj._mat_from_quat(q))


def test_ate_and_umeyama_equal_jax():
    ref = _poses(20, seed=3)
    rng = np.random.default_rng(4)
    est = ref.copy()
    est[:, :3, 3] += rng.normal(0, 0.05, (20, 3))
    T = _poses(1, seed=5)[0]
    moved = np.einsum("ij,njk->nik", T, est)
    for align in (True, False):
        assert abs(ttraj.ate_rmse(moved, ref, align=align)
                   - jtraj.ate_rmse(moved, ref, align=align)) < 1e-12
        np.testing.assert_allclose(ttraj.ate_errors(moved, ref, align=align),
                                   jtraj.ate_errors(moved, ref, align=align),
                                   rtol=0, atol=1e-12)
    for with_scale in (True, False):
        tR, tt, ts = ttraj.umeyama_alignment(moved[:, :3, 3], ref[:, :3, 3],
                                             with_scale)
        jR, jt, js = jtraj.umeyama_alignment(moved[:, :3, 3], ref[:, :3, 3],
                                             with_scale)
        np.testing.assert_allclose(tR, jR, rtol=0, atol=1e-12)
        np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-12)
        assert abs(ts - js) < 1e-12
    with pytest.raises(ValueError, match="length"):
        ttraj.ate_errors(est[:3], ref)


def test_synthetic_dataset_frames_equal_jax():
    t = list(tds.SyntheticDataset(3, channels=8, columns=64, seed=6))
    j = list(jds.SyntheticDataset(3, channels=8, columns=64, seed=6))
    assert len(t) == len(j) == 3
    for a, b in zip(t, j):
        assert a.stamp == b.stamp
        np.testing.assert_array_equal(a.cloud, b.cloud)
        np.testing.assert_array_equal(a.ground_truth, b.ground_truth)


@pytest.mark.parametrize("fmt", ["pcd", "ply"])
def test_pcl_writer_export_equal_and_cross_read(tmp_path, fmt):
    ds = tds.SyntheticDataset(2, channels=8, columns=64)
    assert tpw.export(ds, tmp_path / "t", fmt) == 2
    assert jpw.export(jds.SyntheticDataset(2, channels=8, columns=64),
                      tmp_path / "j", fmt) == 2
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    for name in names:
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name
    kw = dict(pattern=f"*.{fmt}")
    back_t = list(tds.PcdDirectoryDataset(
        tmp_path / "j", tum_ground_truth=tmp_path / "j" / "ground_truth.tum",
        **kw))
    back_j = list(jds.PcdDirectoryDataset(
        tmp_path / "t", tum_ground_truth=tmp_path / "t" / "ground_truth.tum",
        **kw))
    assert len(back_t) == len(back_j) == 2
    for a, b in zip(back_t, back_j):
        np.testing.assert_array_equal(a.cloud, b.cloud)
        np.testing.assert_array_equal(a.ground_truth, b.ground_truth)
    with pytest.raises(FileNotFoundError):
        tds.PcdDirectoryDataset(tmp_path / "t", pattern="*.xyz")


# ------------------------------------------------------------------- lz4
def _lz4_literal_block(data: bytes) -> bytes:
    """A valid literals-only LZ4 block (with length extension)."""
    lit = len(data)
    if lit < 15:
        return bytes([lit << 4]) + data
    out = bytearray([0xF0])
    rem = lit - 15
    while rem >= 255:
        out.append(255)
        rem -= 255
    out.append(rem)
    return bytes(out) + data


def _lz4_frame(blocks, uncompressed=False) -> bytes:
    out = bytearray(struct.pack("<I", 0x184D2204))
    out += bytes([0x60, 0x40, 0x00])          # FLG v1 indep, BD 64K, HC
    for b in blocks:
        size = len(b) | (0x80000000 if uncompressed else 0)
        out += struct.pack("<I", size) + b
    out += struct.pack("<I", 0)               # EndMark
    return bytes(out)


def test_lz4_blocks_and_frames_round_trip():
    src = b"\x44abcd\x04\x00" + b"\x30xyz"    # literals, overlapping match
    for lib in (tlz4, jlz4):
        dst = bytearray()
        lib.decompress_block(src, dst)
        assert bytes(dst) == b"abcdabcdabcd" + b"xyz"
    payload = bytes(np.random.default_rng(7).integers(0, 256, 1500,
                                                      dtype=np.uint8))
    frames = [
        _lz4_frame([_lz4_literal_block(payload[:700]),
                    _lz4_literal_block(payload[700:])]),
        _lz4_frame([payload], uncompressed=True),
        # block 2's match reaches back into block 1 (linked history)
        _lz4_frame([_lz4_literal_block(payload[:8]), b"\x04\x08\x00\x10Z"]),
        # a skippable frame before a real one
        struct.pack("<II", 0x184D2A50, 3) + b"abc"
        + _lz4_frame([payload], uncompressed=True),
    ]
    expect = [payload, payload, payload[:8] * 2 + b"Z", payload]
    for frame, want in zip(frames, expect):
        assert tlz4.decompress(frame) == jlz4.decompress(frame) == want
    for bad in (b"\xF0\x20abc", b"\x44abcd\x04"):
        for lib in (tlz4, jlz4):
            with pytest.raises(ValueError, match="truncated"):
                lib.decompress_block(bad, bytearray())


# ---------------------------------------------------------------- rosbag
def _rechunk(raw: bytes, compression: bytes, compress) -> bytes:
    """The bag's records after its header record, re-wrapped into one
    compressed chunk record (as tests/test_rosbag.py builds a bz2 bag)."""
    magic = b"#ROSBAG V2.0\n"
    body = raw[len(magic):]
    (h1,) = struct.unpack_from("<I", body, 0)
    (d1,) = struct.unpack_from("<I", body, 4 + h1)
    rest = body[4 + h1 + 4 + d1:]
    comp = compress(rest)
    hdr = b""
    for k, v in {b"op": b"\x05", b"compression": compression,
                 b"size": struct.pack("<I", len(rest))}.items():
        f = k + b"=" + v
        hdr += struct.pack("<I", len(f)) + f
    return (magic + body[:4 + h1 + 4 + d1]
            + struct.pack("<I", len(hdr)) + hdr
            + struct.pack("<I", len(comp)) + comp)


@pytest.mark.parametrize("compression", ["none", "bz2", "lz4"])
def test_bag_frames_equal_jax(tmp_path, compression):
    """A bag written by the port (organized clouds, a flat cloud with a
    ring field, IMU samples) gives the same frames and IMU samples in both
    packages, in every chunk compression."""
    rng = np.random.default_rng(8)
    H, W = 4, 16
    synth = list(tds.SyntheticDataset(3, channels=H, columns=W, seed=3))
    p = tmp_path / "seq.bag"
    with tbag.BagWriter(p) as w:
        for fr in synth:
            w.write_imu("/imu", fr.stamp, [0, 0, 0, 1], rng.normal(0, 1, 3),
                        [0, 0, 9.81])
            w.write_pointcloud2("/pts", fr.stamp + 1e-3, fr.cloud)
    raw = p.read_bytes()
    if compression == "bz2":
        p.write_bytes(_rechunk(raw, b"bz2", bz2.compress))
    elif compression == "lz4":
        p.write_bytes(_rechunk(
            raw, b"lz4", lambda b: _lz4_frame([_lz4_literal_block(b)])))
    got = {}
    for name, lib in (("t", tbag), ("j", jbag)):
        ds = lib.RosbagDataset(p, "/pts", "/imu", channels=H, columns=W)
        got[name] = (list(ds), ds.imu_samples)
    (tf, ti), (jf, ji) = got["t"], got["j"]
    assert len(tf) == len(jf) == 3 and len(ti) == len(ji) == 3
    assert all(type(f) is tds.Frame for f in tf)
    for a, b, s in zip(tf, jf, synth):
        assert a.stamp == b.stamp
        np.testing.assert_array_equal(a.cloud, b.cloud)
        np.testing.assert_array_equal(a.cloud, s.cloud)
    for a, b in zip(ti, ji):
        np.testing.assert_array_equal(a.angular_velocity, b.angular_velocity)
        np.testing.assert_array_equal(a.orientation, b.orientation)
    assert raw == _jax_bag_bytes(tmp_path, synth, H, W)


def _jax_bag_bytes(tmp_path, synth, H, W) -> bytes:
    """The same bag written by the JAX package's writer."""
    rng = np.random.default_rng(8)
    p = tmp_path / "jax.bag"
    with jbag.BagWriter(p) as w:
        for fr in synth:
            w.write_imu("/imu", fr.stamp, [0, 0, 0, 1], rng.normal(0, 1, 3),
                        [0, 0, 9.81])
            w.write_pointcloud2("/pts", fr.stamp + 1e-3, fr.cloud)
    return p.read_bytes()


def test_flat_ring_cloud_organizes_like_jax():
    H, W = 8, 32
    el = np.radians(np.linspace(20, -20, H))
    az = np.linspace(-np.pi, np.pi, W, endpoint=False)
    grid = np.stack([
        5 * np.cos(el)[:, None] * np.cos(az)[None, :],
        5 * np.cos(el)[:, None] * np.sin(az)[None, :],
        5 * np.sin(el)[:, None] * np.ones((1, W))], axis=-1)
    ring = np.repeat(np.arange(H), W)
    flat = grid.reshape(-1, 3).astype(np.float32)
    t = tbag.organize_cloud(flat, ring, H, W)
    np.testing.assert_array_equal(t, jbag.organize_cloud(flat, ring, H, W))
    shifts = np.arange(H) % 4
    np.testing.assert_array_equal(tbag.destagger(t, shifts),
                                  jbag.destagger(t, shifts))
