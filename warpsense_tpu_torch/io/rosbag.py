"""Pure-Python rosbag1 (format 2.0) reader/writer — no ROS dependency.

Counterpart of ``warpsense_tpu/io/rosbag.py`` (numpy only, the same
bytes in and the same frames out; ``RosbagDataset`` yields this package's
``io.dataset.Frame``).  The reference is driven by rosbags of an Ouster
OS1-128 played into ROS topics (launch/warpsense.launch,
README.md:262-279); this module replaces that ingestion path: it parses
the bag container format
directly (records, chunks, connections) and deserializes the two message
types the pipelines consume — ``sensor_msgs/PointCloud2`` and
``sensor_msgs/Imu``.  Compression: ``none``, ``bz2`` (stdlib) and
``lz4`` (``io/lz4.py``).

Also provides the Ouster organized-cloud reconstruction the featsense
front end needs: ``organize_cloud`` rebuilds the (H, W, 3) ring-major grid
from a flat cloud with per-point ring indices, and ``destagger`` undoes
the sensor's per-ring column shift (the role of the ouster driver's
destagger before the reference's mypcl::fromROSMsg consumes the organized
cloud, include/featsense/mypcl.h:33-96).

A minimal writer (``BagWriter``) emits a valid uncompressed bag with
PointCloud2/Imu messages so tests can round-trip real container bytes
without shipping sensor data.
"""
from __future__ import annotations

import bz2
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator

import numpy as np

_MAGIC = b"#ROSBAG V2.0\n"

# record op codes
_OP_MSG = 0x02
_OP_BAG_HEADER = 0x03
_OP_INDEX = 0x04
_OP_CHUNK = 0x05
_OP_CHUNK_INFO = 0x06
_OP_CONNECTION = 0x07

_DATATYPE_NP = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
                5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64}
_NP_DATATYPE = {np.dtype(v): k for k, v in _DATATYPE_NP.items()}


# ------------------------------------------------------------- record layer

def _parse_header(buf: bytes) -> dict[bytes, bytes]:
    fields: dict[bytes, bytes] = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        f = buf[off:off + flen]
        off += flen
        k, _, v = f.partition(b"=")
        fields[k] = v
    return fields


def _emit_header(fields: dict[bytes, bytes]) -> bytes:
    out = b""
    for k, v in fields.items():
        f = k + b"=" + v
        out += struct.pack("<I", len(f)) + f
    return struct.pack("<I", len(out)) + out


def _read_record(f) -> tuple[dict[bytes, bytes], bytes] | None:
    raw = f.read(4)
    if len(raw) < 4:
        return None
    (hlen,) = struct.unpack("<I", raw)
    header = _parse_header(f.read(hlen))
    (dlen,) = struct.unpack("<I", f.read(4))
    return header, f.read(dlen)


# ------------------------------------------------------------ message layer

@dataclass
class PointCloud2:
    stamp: float
    frame_id: str
    height: int
    width: int
    fields: list[tuple[str, int, int, int]]    # (name, offset, datatype, count)
    point_step: int
    row_step: int
    data: bytes
    is_bigendian: bool = False
    is_dense: bool = True

    def field_array(self, name: str) -> np.ndarray:
        """(height*width,) array of one field, gathered out of the packed
        point records (byte gather: point_step need not be aligned)."""
        for fname, off, dt, count in self.fields:
            if fname == name:
                npdt = np.dtype(_DATATYPE_NP[dt])
                n = self.height * self.width
                flat = np.frombuffer(self.data, np.uint8)
                idx = off + np.arange(n, dtype=np.int64) * self.point_step
                gathered = np.stack(
                    [flat[idx + b] for b in range(npdt.itemsize)], axis=-1)
                if self.is_bigendian:
                    gathered = gathered[:, ::-1]
                return np.ascontiguousarray(gathered).ravel().view(npdt)[:n]
        raise KeyError(name)

    def xyz(self) -> np.ndarray:
        """(height, width, 3) float32 (meters, sensor frame)."""
        x = self.field_array("x").astype(np.float32)
        y = self.field_array("y").astype(np.float32)
        z = self.field_array("z").astype(np.float32)
        return np.stack([x, y, z], axis=-1).reshape(
            self.height, self.width, 3)


@dataclass
class ImuMsg:
    stamp: float
    frame_id: str
    orientation: np.ndarray           # (4,) xyzw
    angular_velocity: np.ndarray      # (3,) rad/s
    linear_acceleration: np.ndarray   # (3,) m/s^2


class _Cursor:
    def __init__(self, data: bytes):
        self.d = data
        self.o = 0

    def u8(self):
        v = self.d[self.o]
        self.o += 1
        return v

    def u32(self):
        (v,) = struct.unpack_from("<I", self.d, self.o)
        self.o += 4
        return v

    def f64(self, n=1):
        v = struct.unpack_from(f"<{n}d", self.d, self.o)
        self.o += 8 * n
        return v

    def string(self):
        n = self.u32()
        s = self.d[self.o:self.o + n].decode("utf-8", "replace")
        self.o += n
        return s

    def raw(self, n):
        v = self.d[self.o:self.o + n]
        self.o += n
        return v


def _parse_std_header(c: _Cursor) -> tuple[float, str]:
    c.u32()                            # seq
    sec, nsec = c.u32(), c.u32()
    frame_id = c.string()
    return sec + nsec * 1e-9, frame_id


def parse_pointcloud2(data: bytes) -> PointCloud2:
    c = _Cursor(data)
    stamp, frame_id = _parse_std_header(c)
    height, width = c.u32(), c.u32()
    nfields = c.u32()
    fields = []
    for _ in range(nfields):
        name = c.string()
        off, dt = c.u32(), c.u8()
        count = c.u32()
        fields.append((name, off, dt, count))
    is_bigendian = bool(c.u8())
    point_step, row_step = c.u32(), c.u32()
    dlen = c.u32()
    data_bytes = c.raw(dlen)
    is_dense = bool(c.u8()) if c.o < len(c.d) else True
    return PointCloud2(stamp, frame_id, height, width, fields, point_step,
                       row_step, data_bytes, is_bigendian, is_dense)


def parse_imu(data: bytes) -> ImuMsg:
    c = _Cursor(data)
    stamp, frame_id = _parse_std_header(c)
    orientation = np.asarray(c.f64(4))
    c.f64(9)
    angular = np.asarray(c.f64(3))
    c.f64(9)
    accel = np.asarray(c.f64(3))
    c.f64(9)
    return ImuMsg(stamp, frame_id, orientation, angular, accel)


_PARSERS = {
    "sensor_msgs/PointCloud2": parse_pointcloud2,
    "sensor_msgs/Imu": parse_imu,
}


# ------------------------------------------------------------------- reader

@dataclass
class BagMessage:
    topic: str
    datatype: str
    stamp: float                       # bag receive time (seconds)
    msg: object                        # parsed message or raw bytes


def read_bag(path: str | Path, topics: set[str] | None = None
             ) -> Iterator[BagMessage]:
    """Stream messages from a rosbag1 v2.0 file in chunk order.

    Unknown message types yield raw ``bytes``; PointCloud2/Imu are parsed.
    """
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"not a rosbag 2.0 file: {path}")
        connections: dict[int, tuple[str, str]] = {}
        while True:
            rec = _read_record(f)
            if rec is None:
                return
            header, data = rec
            op = header.get(b"op", b"\x00")[0]
            if op == _OP_CONNECTION:
                conn = int.from_bytes(header[b"conn"], "little")
                topic = header[b"topic"].decode()
                dtype = _parse_header(data).get(b"type", b"").decode()
                connections[conn] = (topic, dtype)
            elif op == _OP_CHUNK:
                comp = header.get(b"compression", b"none").decode()
                if comp == "bz2":
                    payload = bz2.decompress(data)
                elif comp == "lz4":
                    # rosbag --lz4 chunks are standard LZ4 frames (the
                    # reference reads them via roslz4); pure-Python
                    # decoder — host IO, off the device hot path
                    from .lz4 import decompress as _lz4_decompress
                    payload = _lz4_decompress(data)
                elif comp == "none":
                    payload = data
                else:
                    raise NotImplementedError(f"chunk compression {comp!r}")
                import io as _io
                sub = _io.BytesIO(payload)
                while True:
                    srec = _read_record(sub)
                    if srec is None:
                        break
                    sh, sd = srec
                    sop = sh.get(b"op", b"\x00")[0]
                    if sop == _OP_CONNECTION:
                        conn = int.from_bytes(sh[b"conn"], "little")
                        topic = sh[b"topic"].decode()
                        dtype = _parse_header(sd).get(b"type", b"").decode()
                        connections[conn] = (topic, dtype)
                    elif sop == _OP_MSG:
                        m = _emit_msg(sh, sd, connections, topics)
                        if m is not None:
                            yield m
            elif op == _OP_MSG:
                m = _emit_msg(header, data, connections, topics)
                if m is not None:
                    yield m
            # index / chunk-info / bag-header records are skipped


def _emit_msg(header, data, connections, topics) -> BagMessage | None:
    conn = int.from_bytes(header[b"conn"], "little")
    topic, dtype = connections.get(conn, ("?", "?"))
    if topics is not None and topic not in topics:
        return None
    # rosbag1 time field: sec (uint32 LE) then nsec (uint32 LE) — so the
    # LOW half of the little-endian 8-byte value is the seconds
    t = int.from_bytes(header[b"time"], "little")
    stamp = (t & 0xFFFFFFFF) + (t >> 32) * 1e-9
    parser = _PARSERS.get(dtype)
    return BagMessage(topic, dtype, stamp,
                      parser(data) if parser else data)


# ------------------------------------------------------------------- writer

class BagWriter:
    """Minimal uncompressed rosbag1 v2.0 writer (one chunk per message).

    Enough structure for this repo's reader and for `rosbag info`-style
    consumers that follow chunks; no index records are written (players
    that require an index must reindex)."""

    def __init__(self, path: str | Path):
        self.f = open(path, "wb")
        self.f.write(_MAGIC)
        self._write_record({b"op": bytes([_OP_BAG_HEADER]),
                            b"index_pos": (0).to_bytes(8, "little"),
                            b"conn_count": (0).to_bytes(4, "little"),
                            b"chunk_count": (0).to_bytes(4, "little")},
                           b"\x20" * 4096)
        self._conns: dict[str, int] = {}

    def _write_record(self, header: dict[bytes, bytes], data: bytes) -> None:
        self.f.write(_emit_header(header))
        self.f.write(struct.pack("<I", len(data)) + data)

    def _connection(self, topic: str, datatype: str) -> int:
        if topic in self._conns:
            return self._conns[topic]
        cid = len(self._conns)
        self._conns[topic] = cid
        conn_data = _emit_header({b"topic": topic.encode(),
                                  b"type": datatype.encode(),
                                  b"md5sum": b"*",
                                  b"message_definition": b""})[4:]
        self._write_record({b"op": bytes([_OP_CONNECTION]),
                            b"conn": cid.to_bytes(4, "little"),
                            b"topic": topic.encode()}, conn_data)
        return cid

    def write(self, topic: str, datatype: str, stamp: float,
              payload: bytes) -> None:
        cid = self._connection(topic, datatype)
        sec = int(stamp)
        nsec = int(round((stamp - sec) * 1e9))
        t = sec | (nsec << 32)          # sec LE then nsec LE on the wire
        self._write_record({b"op": bytes([_OP_MSG]),
                            b"conn": cid.to_bytes(4, "little"),
                            b"time": t.to_bytes(8, "little")}, payload)

    def write_pointcloud2(self, topic: str, stamp: float,
                          cloud: np.ndarray, frame_id: str = "os1") -> None:
        """cloud: (H, W, 3) or (N, 3) float32 meters."""
        cloud = np.asarray(cloud, np.float32)
        if cloud.ndim == 2:
            cloud = cloud[None]
        H, W, _ = cloud.shape
        body = struct.pack("<III", 0, int(stamp),
                           int(round((stamp - int(stamp)) * 1e9)))
        fid = frame_id.encode()
        body += struct.pack("<I", len(fid)) + fid
        body += struct.pack("<II", H, W)
        body += struct.pack("<I", 3)
        for i, name in enumerate((b"x", b"y", b"z")):
            body += struct.pack("<I", 1) + name
            body += struct.pack("<IBI", 4 * i, 7, 1)
        data = cloud.astype("<f4").tobytes()
        body += struct.pack("<BII", 0, 12, 12 * W)
        body += struct.pack("<I", len(data)) + data
        body += struct.pack("<B", 1)
        self.write(topic, "sensor_msgs/PointCloud2", stamp, body)

    def write_imu(self, topic: str, stamp: float, orientation_xyzw,
                  angular_velocity, linear_acceleration,
                  frame_id: str = "imu") -> None:
        body = struct.pack("<III", 0, int(stamp),
                           int(round((stamp - int(stamp)) * 1e9)))
        fid = frame_id.encode()
        body += struct.pack("<I", len(fid)) + fid
        body += struct.pack("<4d", *np.asarray(orientation_xyzw, np.float64))
        body += struct.pack("<9d", *([0.0] * 9))
        body += struct.pack("<3d", *np.asarray(angular_velocity, np.float64))
        body += struct.pack("<9d", *([0.0] * 9))
        body += struct.pack("<3d", *np.asarray(linear_acceleration,
                                               np.float64))
        body += struct.pack("<9d", *([0.0] * 9))
        self.write(topic, "sensor_msgs/Imu", stamp, body)

    def close(self) -> None:
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ------------------------------------------- organized-cloud reconstruction

def organize_cloud(points: np.ndarray, ring: np.ndarray, channels: int,
                   columns: int) -> np.ndarray:
    """Flat cloud + per-point ring -> (channels, columns, 3) organized grid.

    Column = azimuth bin (atan2 over the full turn); collisions keep the
    nearest return, holes stay zero (the featsense front end treats zero
    rows as invalid).  This is the ingestion step for bags whose driver
    published flat clouds with a ``ring`` field instead of organized rows.
    """
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    ring = np.asarray(ring).astype(np.int64).reshape(-1)
    az = np.arctan2(pts[:, 1], pts[:, 0])
    col = np.round((az + np.pi) / (2 * np.pi) * columns).astype(np.int64) \
        % columns
    rng = np.linalg.norm(pts, axis=1)
    ok = (rng > 0.1) & (ring >= 0) & (ring < channels)
    out = np.zeros((channels, columns, 3), np.float32)
    flat = ring * columns + col
    order = np.argsort(rng, kind="stable")[::-1]     # nearest written last
    f = flat[order][ok[order]]
    out.reshape(-1, 3)[f] = pts[order][ok[order]]
    return out


def destagger(img: np.ndarray, shifts: np.ndarray) -> np.ndarray:
    """Undo the Ouster per-ring column shift: row r rolls left by
    ``shifts[r]`` (the sensor's pixel_shift_by_row metadata)."""
    out = np.empty_like(img)
    shifts = np.asarray(shifts, np.int64)
    for r in range(img.shape[0]):
        out[r] = np.roll(img[r], -int(shifts[r]), axis=0)
    return out


class RosbagDataset:
    """Bag-backed scan sequence (the reference's rosbag playback role).

    Yields ``io.dataset.Frame``s from a PointCloud2 topic; organized
    (H > 1) clouds pass through as (H, W, 3), flat clouds with a ``ring``
    field are reconstructed via ``organize_cloud``.  IMU samples from
    ``imu_topic`` are available via ``imu_samples`` after iteration (or
    pushed into a callback passed to ``__iter__``)."""

    def __init__(self, path: str | Path, cloud_topic: str,
                 imu_topic: str | None = None, *, channels: int = 128,
                 columns: int = 1024, destagger_shifts=None):
        self.path = Path(path)
        self.cloud_topic = cloud_topic
        self.imu_topic = imu_topic
        self.channels = channels
        self.columns = columns
        self.destagger_shifts = destagger_shifts
        self.imu_samples: list[ImuMsg] = []

    def __iter__(self):
        from .dataset import Frame
        topics = {self.cloud_topic}
        if self.imu_topic:
            topics.add(self.imu_topic)
        for m in read_bag(self.path, topics):
            if m.topic == self.imu_topic and isinstance(m.msg, ImuMsg):
                self.imu_samples.append(m.msg)
                continue
            if not isinstance(m.msg, PointCloud2):
                continue
            pc = m.msg
            if pc.height > 1:
                cloud = pc.xyz()
            else:
                try:
                    ring = pc.field_array("ring")
                except KeyError:
                    cloud = pc.xyz().reshape(-1, 3)
                    yield Frame(stamp=pc.stamp or m.stamp, cloud=cloud)
                    continue
                cloud = organize_cloud(pc.xyz().reshape(-1, 3), ring,
                                       self.channels, self.columns)
            if self.destagger_shifts is not None:
                cloud = destagger(cloud, self.destagger_shifts)
            yield Frame(stamp=pc.stamp or m.stamp, cloud=cloud)


def bag_to_npz(bag_path: str | Path, out_path: str | Path, cloud_topic: str,
               imu_topic: str | None = None, **kw) -> int:
    """Convert a bag to a compressed .npz of stacked organized scans (+
    IMU arrays); returns the number of scans written."""
    ds = RosbagDataset(bag_path, cloud_topic, imu_topic, **kw)
    clouds, stamps = [], []
    for fr in ds:
        clouds.append(fr.cloud)
        stamps.append(fr.stamp)
    imu = ds.imu_samples
    np.savez_compressed(
        out_path,
        clouds=np.stack(clouds) if clouds else np.zeros((0, 0, 0, 3)),
        stamps=np.asarray(stamps),
        imu_stamps=np.asarray([m.stamp for m in imu]),
        imu_angular=np.stack([m.angular_velocity for m in imu])
        if imu else np.zeros((0, 3)),
        imu_accel=np.stack([m.linear_acceleration for m in imu])
        if imu else np.zeros((0, 3)),
        imu_orientation=np.stack([m.orientation for m in imu])
        if imu else np.zeros((0, 4)))
    return len(clouds)
