"""The JAX FastsenseApp and the JAX slam_eval CLI on chip_smoke.py's
FASTSENSE and SLAM_EVAL inputs, on the CPU: the references behind
chip_smoke's FASTSENSE_JAX_ATE_M and SLAM_EVAL_JAX_ATE_M.

    JAX_PLATFORMS=cpu python tests/_jax_fastsense_reference.py \
        [fastsense|slam_eval ...]

fastsense: warpsense_tpu's FastsenseApp at configs/default.yaml (parity
mode, tau 1000 mm) on FASTSENSE_APP's 12 scans with an orientation IMU
sample before each and ``sync()`` after each, at the window
FASTSENSE_JAX_WINDOW_M (whole meters; the card runs 625 x 625 x 391,
which the CPU sweeps too slowly).  slam_eval: ``warpsense_tpu.eval.
slam_eval.main`` with each of SLAM_EVAL_ARGS.  Prints one JSON line per
run with the ATE in chip_smoke's definitions."""
import contextlib
import io
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
from warpsense_tpu.eval import slam_eval  # noqa: E402
from warpsense_tpu.io.trajectory import _quat_from_mat  # noqa: E402
from warpsense_tpu.pipeline.fastsense import FastsenseApp  # noqa: E402
from warpsense_tpu.utils.imu import ImuSample  # noqa: E402


def fastsense() -> dict:
    cfg = cs.FASTSENSE_APP
    gt, scans = cs.app_scans(cfg)
    params = Params.from_yaml(ROOT / "warpsense_tpu" / "configs"
                              / "default.yaml")
    m = params.map
    m.size_x, m.size_y, m.size_z = cs.FASTSENSE_JAX_WINDOW_M
    m.__post_init__()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        app = FastsenseApp(params, map_path=Path(tmp) / "map.h5",
                           capacity=cfg["capacity"],
                           update_frequency=cfg["update_frequency"],
                           update_distance_m=cfg["update_distance_m"])
        poses = []
        for i, (scan, q) in enumerate(zip(scans, cs.fastsense_imu(gt))):
            app.imu_callback(ImuSample(0.1 * i - 1e-3, np.zeros(3), q))
            poses.append(np.asarray(app.cloud_callback(scan, 0.1 * i)))
            app.sync()
        jobs = app._jobs_submitted
        app.terminate()
    return dict(run="fastsense", window=list(m.size_voxels),
                scans=len(scans), jobs=jobs, ate_m=cs.ate_m(poses, gt),
                positions_mm=[p[:3, 3].round(3).tolist() for p in poses],
                finite=bool(np.all(np.isfinite(np.stack(poses)))),
                seconds=time.perf_counter() - t0)


def run_slam_eval(name: str) -> dict:
    t0 = time.perf_counter()
    out = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(out):
        slam_eval.main(cs.SLAM_EVAL_ARGS[name]
                       + ["--map-out", str(Path(tmp) / "m.h5")])
    stats = json.loads(out.getvalue().strip().splitlines()[-1])
    return dict(run=f"slam_eval_{name}", **stats,
                seconds=time.perf_counter() - t0)


def main(argv) -> int:
    runs = argv[1:] or ["fastsense", "slam_eval"]
    for run in runs:
        results = ([fastsense()] if run == "fastsense"
                   else [run_slam_eval(n) for n in cs.SLAM_EVAL_ARGS])
        for r in results:
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
