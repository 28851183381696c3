"""CUDA device query: the reference ships NVIDIA's ``deviceQuery`` sample
for this (built at CMakeLists.txt:106-111).

Counterpart of ``warpsense_tpu/utils/device_query.py``.  Prints one JSON
object per visible GPU with the fields this package's rooflines need:
name, memory, SM count, compute capability and the board's power limit
(``nvidia-smi``; a card set below its maximum runs slower under load),
and with ``--bandwidth`` a measured device-to-device copy rate (the TSDF
sweep and the registration fields are bandwidth-bound):

    python -m warpsense_tpu_torch.utils.device_query [--bandwidth]

Without a GPU it raises: it never describes the CPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess

COPY_BYTES = 1 << 30
COPY_REPS = 5


def _power_limits() -> list[str]:
    """``power.limit`` of each GPU as nvidia-smi prints it ("700.00 W")."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def copy_bandwidth(device) -> dict:
    """Median of ``COPY_REPS`` device-to-device ``copy_`` of 1 GiB, timed
    with CUDA events: its ms and the rate counting each byte read once and
    written once."""
    import torch
    src = torch.empty(COPY_BYTES, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    dst.copy_(src)                              # warm-up
    times = []
    for _ in range(COPY_REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        dst.copy_(src)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    ms = sorted(times)[len(times) // 2]
    return {"copy_bytes": COPY_BYTES, "copy_ms": ms,
            "copy_gbps": 2 * COPY_BYTES / (ms * 1e-3) / 1e9}


def query(bandwidth: bool = False) -> list[dict]:
    """One record per visible GPU; raises when there is none."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("device_query: torch.cuda.is_available() is False "
                           "(no GPU, or a CPU-only PyTorch build)")
    limits = _power_limits()
    out = []
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        info = {"id": i, "platform": "gpu", "name": p.name,
                "memory_bytes": int(p.total_memory),
                "sm_count": int(p.multi_processor_count),
                "compute_capability": f"{p.major}.{p.minor}",
                "power_limit": limits[i] if i < len(limits) else None}
        if bandwidth:
            info.update(copy_bandwidth(torch.device("cuda", i)))
        out.append(info)
    return out


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--bandwidth", action="store_true",
                    help="measure each GPU's device-to-device copy rate")
    args = ap.parse_args(argv)
    infos = query(bandwidth=args.bandwidth)
    for info in infos:
        print(json.dumps(info))
    return infos


if __name__ == "__main__":
    main()
