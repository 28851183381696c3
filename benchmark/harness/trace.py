"""Reading a ``torch.profiler`` chrome trace: device intervals, host ranges
and which range launched each device operation.

A device operation (a kernel, a copy or a fill) belongs to the host range
in which the call that launched it was made: the launch is the runtime or
driver event with the operation's correlation id, and its host timestamp
falls inside the range.  Nothing here matches kernel names.
"""
from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
RANGE_CAT = "user_annotation"


@dataclass
class Trace:
    """Seconds throughout (the trace's clock, microseconds, / 1e6)."""
    device: list = field(default_factory=list)    # (start, end, name, launch)
    ranges: list = field(default_factory=list)    # (start, end, name)
    _by_launch: list | None = None
    _launch_ts: list | None = None

    def ranges_named(self, prefix: str) -> list:
        return [r for r in self.ranges if r[2].startswith(prefix)]

    def device_in(self, rng) -> list:
        """The device operations launched inside the host range ``rng``."""
        if self._by_launch is None:
            self._by_launch = sorted(
                (d for d in self.device if d[3] is not None),
                key=lambda d: d[3])
            self._launch_ts = [d[3] for d in self._by_launch]
        lo = bisect.bisect_left(self._launch_ts, rng[0])
        hi = bisect.bisect_right(self._launch_ts, rng[1])
        return self._by_launch[lo:hi]

    def device_seconds_in(self, rng) -> float:
        return sum(d[1] - d[0] for d in self.device_in(rng))


def parse(doc: dict) -> Trace:
    """The trace of a chrome-trace document (``export_chrome_trace``)."""
    launches = {}
    device, ranges = [], []
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        args = e.get("args") or {}
        ts = float(e.get("ts", 0.0)) / 1e6
        dur = float(e.get("dur", 0.0)) / 1e6
        if cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = ts
        elif cat in DEVICE_CATS:
            device.append((ts, ts + dur, e.get("name", ""),
                           args.get("correlation")))
        elif cat == RANGE_CAT:
            ranges.append((ts, ts + dur, e.get("name", "")))
    device = [(a, b, n, launches.get(c)) for a, b, n, c in device]
    device.sort()
    ranges.sort()
    return Trace(device=device, ranges=ranges)


def load(path) -> Trace:
    with open(path) as fh:
        return parse(json.load(fh))
