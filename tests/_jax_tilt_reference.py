"""The JAX fast app on chip_smoke.py's tilted walk, on the CPU: the
reference behind chip_smoke's TILT_JAX_ATE_M.

    JAX_PLATFORMS=cpu python tests/_jax_tilt_reference.py [X Y Z]

Runs warpsense_tpu's WarpsenseApp in fast mode on TILT_APP's scans with
TILT_APP's settings, fusion pinned to "projective-level" (the level grid
inside the 2 degree budget, the attitude grid beyond it; JAX's "auto" picks
another route off a TPU) and synchronous shifts, at a window that holds the
room (default 321 x 221 x 111; the card runs TILT_APP at 625 x 625 x 235,
which the CPU sweeps too slowly).  Prints each scan's tilt and grid, and the
ATE in chip_smoke's definition, as one JSON line."""
import json
import sys
import tempfile
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from warpsense_tpu.core.config import Params  # noqa: E402
from warpsense_tpu.pipeline import fusion_backend as jfb  # noqa: E402
from warpsense_tpu.pipeline.warpsense import WarpsenseApp  # noqa: E402


def main(argv) -> int:
    window = tuple(int(a) for a in argv[1:4]) or (321, 221, 111)
    cfg = cs.TILT_APP
    gt, scans = cs.app_scans(cfg)
    params = Params.from_dict(cs.app_config(cfg))
    with tempfile.TemporaryDirectory() as tmp:
        app = WarpsenseApp(params, map_path=Path(tmp) / "map.h5",
                           capacity=cfg["capacity"], window_size=window,
                           force_odd=False, fusion="projective-level",
                           sync_shift=True)
        pos0 = np.asarray(app.state.pos).copy()
        poses, tilts, levels = [], [], []
        t0 = time.perf_counter()
        for i, scan in enumerate(scans):
            pose = np.asarray(app.cloud_callback(scan, 0.1 * i))
            poses.append(pose)
            tilts.append(jfb.sensor_tilt_deg(pose))
            levels.append(bool(jfb.grid_rotation_for(
                pose, params.lidar.vfov)[1]))
        shifted = bool(np.any(np.asarray(app.state.pos) != pos0))
        app.terminate()
    print(json.dumps(dict(
        window=list(window), scans=len(scans), ate_m=cs.ate_m(poses, gt),
        tilt_deg=tilts, level_grid=levels, shifted=shifted,
        finite=bool(np.all(np.isfinite(np.stack(poses)))),
        seconds=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
