"""The JAX offline CLIs at their defaults, on the CPU: the reference behind
chip_smoke's OFFLINE_JAX_AVG_MM.

    JAX_PLATFORMS=cpu python tests/_jax_offline_reference.py

Runs warpsense_tpu's eval.pcd2tsdf and eval.pcd_registration as their CLIs
run with no arguments (the synthetic BoxWorld scan of ``_load_cloud``) and
prints pcd2tsdf's stats and each registration case's re-projection error
(mm), one JSON line each, each followed by the module's seconds."""
import json
import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from warpsense_tpu.eval import pcd2tsdf, pcd_registration  # noqa: E402


def main() -> int:
    for mod in (pcd2tsdf, pcd_registration):
        t0 = time.perf_counter()
        mod.main([])             # prints its result as one JSON line
        print(json.dumps(dict(module=mod.__name__,
                              seconds=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
