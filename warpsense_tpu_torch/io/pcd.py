"""PCD / PLY point-cloud file IO.

Counterpart of ``warpsense_tpu/io/pcd.py`` (numpy only; files written
here are byte-equal to the JAX package's).

Replaces the reference's PCL file plumbing (pcl::io::loadPCDFile in
test/pcd2tsdf.cpp:40, pcl::io::savePCDFileASCII /
savePLYFileASCII in src/visualization/pcl_writer.cpp:60-75)
without PCL: a small, dependency-free reader/writer for the subset the
pipeline needs — XYZ(+intensity) clouds, ASCII and binary encodings.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

_PCD_DTYPES = {("F", 4): "f4", ("F", 8): "f8",
               ("I", 1): "i1", ("I", 2): "i2", ("I", 4): "i4",
               ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}


def read_pcd(path: str | Path) -> np.ndarray:
    """Load a PCD file -> (N, C) float32 array (columns in field order,
    x/y/z first by convention).  Supports ascii and binary encodings."""
    path = Path(path)
    with open(path, "rb") as f:
        header: dict[str, list[str]] = {}
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            if not line or line.startswith("#"):
                continue
            key, *vals = line.split()
            header[key.upper()] = vals
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        n = int(header["POINTS"][0])
        mode = header["DATA"][0].lower()

        dtype = np.dtype([
            (name if c == 1 else f"{name}", _PCD_DTYPES[(t, s)], (c,))
            if c > 1 else (name, _PCD_DTYPES[(t, s)])
            for name, t, s, c in zip(fields, types, sizes, counts)])
        if mode == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, max_rows=n)
            raw = raw.reshape(n, -1)
            out = raw[:, :sum(counts)]
        elif mode == "binary":
            buf = f.read(dtype.itemsize * n)
            rec = np.frombuffer(buf, dtype=dtype, count=n)
            out = np.stack([rec[name].reshape(n, -1).astype(np.float64)
                            for name in dtype.names], axis=1).reshape(n, -1)
        else:
            raise ValueError(f"unsupported PCD DATA mode: {mode}")
    return out.astype(np.float32)


def write_pcd(path: str | Path, points: np.ndarray, *,
              binary: bool = True) -> None:
    """Write an (N, 3) or (N, 4) float cloud as x y z [intensity]."""
    points = np.asarray(points, dtype=np.float32)
    n, c = points.shape
    fields = ["x", "y", "z", "intensity"][:c]
    header = "\n".join([
        "# .PCD v0.7 - Point Cloud Data file format",
        "VERSION 0.7",
        f"FIELDS {' '.join(fields)}",
        f"SIZE {' '.join(['4'] * c)}",
        f"TYPE {' '.join(['F'] * c)}",
        f"COUNT {' '.join(['1'] * c)}",
        f"WIDTH {n}",
        "HEIGHT 1",
        "VIEWPOINT 0 0 0 1 0 0 0",
        f"POINTS {n}",
        f"DATA {'binary' if binary else 'ascii'}",
    ]) + "\n"
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(np.ascontiguousarray(points).tobytes())
        else:
            np.savetxt(f, points, fmt="%.6f")


def write_ply(path: str | Path, points: np.ndarray,
              colors: np.ndarray | None = None, *,
              binary: bool = True) -> None:
    """Write an (N, 3) cloud (optionally with (N, 3) uint8 colors) as PLY."""
    points = np.asarray(points, dtype=np.float32)
    n = len(points)
    props = ["property float x", "property float y", "property float z"]
    if colors is not None:
        colors = np.asarray(colors, dtype=np.uint8)
        props += ["property uchar red", "property uchar green",
                  "property uchar blue"]
    fmt = ("binary_little_endian" if binary else "ascii")
    header = "\n".join(["ply", f"format {fmt} 1.0",
                        f"element vertex {n}", *props, "end_header"]) + "\n"
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            if colors is None:
                f.write(np.ascontiguousarray(points).tobytes())
            else:
                rec = np.zeros(n, dtype=[("xyz", "f4", (3,)),
                                         ("rgb", "u1", (3,))])
                rec["xyz"] = points
                rec["rgb"] = colors
                f.write(rec.tobytes())
        else:
            if colors is None:
                np.savetxt(f, points, fmt="%.6f")
            else:
                for p, c in zip(points, colors):
                    f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                            f"{c[0]} {c[1]} {c[2]}\n".encode("ascii"))


def read_ply(path: str | Path) -> np.ndarray:
    """Load vertex x/y/z from an ASCII or binary_little_endian PLY."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a PLY file")
        fmt = None
        n = 0
        props: list[tuple[str, str]] = []
        _PLY = {"float": "f4", "float32": "f4", "double": "f8",
                "uchar": "u1", "uint8": "u1", "char": "i1", "int": "i4",
                "uint": "u4", "short": "i2", "ushort": "u2"}
        in_vertex = False
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                in_vertex = name == "vertex"
                if in_vertex:
                    n = int(cnt)
            elif line.startswith("property") and in_vertex:
                _, t, name = line.split()
                props.append((name, _PLY[t]))
            elif line == "end_header":
                break
        dtype = np.dtype(props)
        if fmt == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, max_rows=n).reshape(n, -1)
            names = [p[0] for p in props]
            ix = [names.index(a) for a in ("x", "y", "z")]
            return raw[:, ix].astype(np.float32)
        rec = np.frombuffer(f.read(dtype.itemsize * n), dtype=dtype, count=n)
        return np.stack([rec["x"], rec["y"], rec["z"]],
                        axis=1).astype(np.float32)
