"""Generic named-CSV emitter.

Counterpart of ``warpsense_tpu/obs/csv_wrapper.py``.

Parity: include/util/csv_wrapper.h:12-140 — columns are
registered by name, values appended per column, rows flushed to disk with
a separator; used for ad-hoc measurement series (the reference's kd-tree
timing instrumentation, util/kdtree_measurements.h, is one thin consumer).
"""
from __future__ import annotations

from pathlib import Path


class CSVWrapper:
    def __init__(self, path: str | Path, separator: str = ","):
        self.path = Path(path)
        self.separator = separator
        self._columns: dict[str, list] = {}

    def add_column(self, name: str) -> None:
        self._columns.setdefault(name, [])

    def add_value(self, column: str, value) -> None:
        self._columns.setdefault(column, []).append(value)

    def add_row(self, **values) -> None:
        for k, v in values.items():
            self.add_value(k, v)

    def write(self) -> None:
        names = list(self._columns)
        n = max((len(v) for v in self._columns.values()), default=0)
        with open(self.path, "w") as f:
            f.write(self.separator.join(names) + "\n")
            for i in range(n):
                row = [str(self._columns[k][i]) if i < len(self._columns[k])
                       else "" for k in names]
                f.write(self.separator.join(row) + "\n")


class KDTreeMeasurements(CSVWrapper):
    """Association-timing instrumentation with the reference's schema
    (util/kdtree_measurements.h:6-37): per-frame build/query timings."""

    def __init__(self, path: str | Path):
        super().__init__(path)
        for c in ("frame", "points", "build_us", "query_us"):
            self.add_column(c)

    def record(self, frame: int, points: int, build_us: float,
               query_us: float) -> None:
        self.add_row(frame=frame, points=points, build_us=build_us,
                     query_us=query_us)
