"""Span profiler with the reference's RuntimeEvaluator semantics.

Parity target: include/util/runtime_evaluator.h +
src/util/runtime_evaluator.cpp —

* named start/stop spans with **self-exclusion**: time spent inside the
  evaluator's own calls is subtracted from every active span
  (runtime_evaluator.h:191-200);
* per-task count / last / min / max / sum and a 100-sample sliding-window
  running average (runtime_evaluator.h:24-53);
* CSV export with the schema ``task,count,last,min,max,avg,run_avg``
  (runtime_evaluator.cpp:29), microsecond integers;
* a histogram of the "total" span in 10 ms buckets.

Additions for the device runtime: synchronisation is the caller's job
(CUDA launches are async — a span around a kernel launch must
wrap a blocking get), and spans can be used as context managers.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field


@dataclass
class _Form:
    name: str
    active: bool = False
    started: int = 0            # ns timestamp of last resume
    accumulated: int = 0        # ns, running span
    count: int = 0
    last: int = 0               # ns
    sum: int = 0
    min: int = 2 ** 63 - 1
    max: int = 0
    window: deque = field(default_factory=lambda: deque(maxlen=100))

    def stop_with(self, ns: int) -> None:
        self.active = False
        self.count += 1
        self.last = ns
        self.sum += ns
        self.min = min(self.min, ns)
        self.max = max(self.max, ns)
        self.window.append(ns)

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0

    @property
    def run_avg(self) -> float:
        return sum(self.window) / len(self.window) if self.window else 0.0


class RuntimeEvaluator:
    """Singleton span accumulator (get_instance(), like the reference)."""

    _instance: "RuntimeEvaluator | None" = None
    _instance_lock = threading.Lock()

    @classmethod
    def get_instance(cls) -> "RuntimeEvaluator":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def __init__(self) -> None:
        self._forms: dict[str, _Form] = {}
        self._lock = threading.Lock()
        self._pause_started = 0
        self.histogram: dict[int, int] = {}   # 10ms bucket -> count

    # -- self-exclusion: pause all active spans while we do bookkeeping
    def _pause(self) -> None:
        now = time.perf_counter_ns()
        for f in self._forms.values():
            if f.active:
                f.accumulated += now - f.started  # type: ignore[attr-defined]

    def _resume(self) -> None:
        now = time.perf_counter_ns()
        for f in self._forms.values():
            if f.active:
                f.started = now  # type: ignore[attr-defined]

    def start(self, task: str) -> None:
        with self._lock:
            self._pause()
            f = self._forms.setdefault(task, _Form(task))
            if f.active:
                raise RuntimeError(f"span '{task}' started twice")
            f.active = True
            f.accumulated = 0
            self._resume()

    def stop(self, task: str) -> None:
        with self._lock:
            self._pause()
            f = self._forms.get(task)
            if f is None or not f.active:
                raise RuntimeError(f"span '{task}' stopped without start")
            f.stop_with(f.accumulated)
            if task == "total":
                bucket = int(f.last / 1e6 // 10)
                self.histogram[bucket] = self.histogram.get(bucket, 0) + 1
            self._resume()

    class _Span:
        def __init__(self, ev: "RuntimeEvaluator", task: str):
            self.ev, self.task = ev, task

        def __enter__(self):
            self.ev.start(self.task)

        def __exit__(self, *exc):
            self.ev.stop(self.task)

    def span(self, task: str) -> "_Span":
        return RuntimeEvaluator._Span(self, task)

    # ------------------------------------------------------------------ export
    def to_rows(self) -> list[dict]:
        us = 1000
        return [{
            "task": f.name, "count": f.count, "last": f.last // us,
            "min": (0 if f.count == 0 else f.min // us), "max": f.max // us,
            "avg": int(f.avg) // us, "run_avg": int(f.run_avg) // us,
        } for f in self._forms.values()]

    def export_results(self, path) -> None:
        import csv
        with open(path, "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=[
                "task", "count", "last", "min", "max", "avg", "run_avg"])
            w.writeheader()
            for row in self.to_rows():
                w.writerow(row)

    def __str__(self) -> str:
        head = f"{'task':>20} | {'count':>6} | {'last':>8} | {'avg':>8} | {'run_avg':>8}\n"
        body = "".join(
            f"{r['task']:>20} | {r['count']:>6} | {r['last']:>8} | "
            f"{r['avg']:>8} | {r['run_avg']:>8}\n" for r in self.to_rows())
        return head + body

    def clear(self) -> None:
        with self._lock:
            self._forms.clear()
            self.histogram.clear()
