"""Scenes for the fusion's table step (``kernels/fusion.fusion_table``):
the CPU tests hold its plain path to the JAX twin's table, and
the card tests hold the kernel to the plain path, on the same scenes.
Imports no JAX (the GPU machine has none)."""
import math

import numpy as np
import torch

from warpsense_tpu_torch.io.synthetic import box_room_cloud

TAU, RES = 600, 64
SIZE = (96, 80, 45)

SCENES = ("level", "6.0-vfov90-rolled", "ring-offset", "outside-window",
          "equal-keys", "empty-mask", "slab")


def _tilt(deg):
    a = math.radians(deg)
    return np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                     [-math.sin(a), 0, math.cos(a)]], np.float32)


def _roll(rad):
    c, s = math.cos(rad), math.sin(rad)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)


def scene(name: str, device) -> dict:
    """The inputs of one table step: the cloud (int32 mm) and its mask,
    the window's ``pos`` and ``offset`` (int32 tensors), the scanner's
    voxel (three ints), the grid rotation (CPU), the window's ``size`` and
    ``x_rows``, and the table's ``kw`` (tau, resolution, channels,
    columns, vfov_deg).

    - level: the level grid at the window's center;
    - 6.0-vfov90-rolled: a 6 degree tilt with a 0.05 rad roll at a 90
      degree vertical field of view (the handheld OS0-128's case);
    - ring-offset: after a shift, the ring offset nonzero on every axis;
    - outside-window: a room wider in y than the window grown by tau / 2,
      so the gate drops points (the y walls and the x walls' ends);
    - equal-keys: points 0 and 1 share a beam and a range / 8 mm, so the
      key's index decides (point 0, the farther, wins);
    - empty-mask: no point is a return;
    - slab: a rank's array x rows [30, 61) of the window, tilted."""
    if name not in SCENES:
        raise ValueError(name)
    s = dict(pos=(0, 0, 0), offset=tuple(v // 2 for v in SIZE),
             scanner=(0, 0, 0), rotation=np.eye(3, dtype=np.float32),
             x_rows=None, vfov_deg=45.0, half=2000, zhalf=1000)
    if name == "6.0-vfov90-rolled":
        s.update(rotation=_tilt(6.0) @ _roll(0.05), vfov_deg=90.0,
                 scanner=(1, -1, 0))
    elif name == "ring-offset":
        s.update(pos=(3, -2, 1), offset=(5, 71, 9), scanner=(3, -2, 1))
    elif name == "outside-window":
        s.update(half=3000, scanner=(2, 1, 0))
    elif name == "slab":
        s.update(x_rows=(30, 61), rotation=_tilt(12.0), scanner=(2, 0, 1))
    pts = box_room_cloud(20000, s["half"], s["zhalf"])
    mask = np.ones(len(pts), bool)
    if name == "equal-keys":
        smm = np.array(s["scanner"]) * RES + RES // 2
        # ranges 1001.0005 and 1000 mm: both 125 once divided by 8 mm
        pts[:2] = smm + np.array([[1001, 1, 0], [1000, 0, 0]])
    elif name == "empty-mask":
        mask[:] = False
    i32 = dict(dtype=torch.int32, device=device)
    return dict(points=torch.as_tensor(pts, **i32),
                mask=torch.as_tensor(mask, device=device),
                pos=torch.tensor(s["pos"], **i32),
                offset=torch.tensor(s["offset"], **i32),
                scanner=s["scanner"],
                rotation=torch.as_tensor(s["rotation"]), size=SIZE,
                x_rows=s["x_rows"],
                kw=dict(tau=TAU, resolution=RES, channels=128, columns=1024,
                        vfov_deg=s["vfov_deg"]))


def table_args(sc: dict) -> tuple[tuple, dict]:
    """``fusion_table``'s arguments for a scene."""
    return ((sc["points"], sc["mask"], sc["pos"], sc["offset"],
             sc["scanner"], sc["rotation"]),
            dict(size=sc["size"], x_rows=sc["x_rows"], **sc["kw"]))
