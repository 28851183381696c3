"""Span profiler with the reference's RuntimeEvaluator semantics, on the
device's clock.

Parity target: include/util/runtime_evaluator.h +
src/util/runtime_evaluator.cpp —

* named start/stop spans with **self-exclusion**: time spent inside the
  evaluator's own calls is subtracted from every span open on the calling
  thread (runtime_evaluator.h:191-200);
* per-task count / last / min / max / sum and a 100-sample sliding-window
  running average (runtime_evaluator.h:24-53);
* CSV export with the schema ``task,count,last,min,max,avg,run_avg``
  (runtime_evaluator.cpp:29), microsecond integers.

Additions for the device runtime:

* **No synchronisation.**  After ``use_device(cuda)`` each ``stop``
  records a CUDA event on the device's current stream.  A span lasts from
  its host start to the later of its host end (less the evaluator's own
  time) and the event's completion: the time until the work it launched
  is done.  The completion is placed on the ``perf_counter_ns`` clock
  through an anchor event taken (with the evaluator's only synchronize)
  when the device is set and at ``clear()``, and clamped to the host
  times that bound it.  Finished events are folded in by ``query()`` at
  later ``start``/``stop`` calls and at every read of ``_forms``, so a
  read after the caller's own ``torch.cuda.synchronize()`` sees them all.
* **Records.**  Each span keeps its name, thread, parent (the innermost
  span open on its own thread), scan id (``set_scan``, per thread), host
  start and end and device completion, in a bounded ring that
  ``export_spans`` writes as chrome-trace JSON, one track a thread.
* **Ranges.**  While a ``torch.profiler`` session is on, an open span is
  also a ``record_function`` range named ``span.<task>``, so idle gaps in
  that trace fall under the host work that left them.
* **Counters** (``count``, ``counters``): plain integer sums, cleared
  with the spans.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import torch

RECORDS = 1 << 16           # spans kept for export_spans


@dataclass
class _Form:
    name: str
    count: int = 0
    last: int = 0               # ns
    sum: int = 0
    min: int = 2 ** 63 - 1
    max: int = 0
    window: deque = field(default_factory=lambda: deque(maxlen=100))

    def add(self, ns: int) -> None:
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


class _Record:
    """One span: host times in ``perf_counter_ns``; ``device_end`` is the
    completion of the work launched inside it (None without a device)."""
    __slots__ = ("id", "name", "thread", "parent", "scan", "start", "end",
                 "device_end", "excluded", "range")

    def __init__(self, id_, name, thread, parent, scan):
        self.id, self.name, self.thread = id_, name, thread
        self.parent, self.scan = parent, scan
        self.start = self.end = 0
        self.device_end = None
        self.excluded = 0           # ns of the evaluator's own calls inside
        self.range = None

    def duration(self) -> int:
        host = self.end - self.start - self.excluded
        if self.device_end is None:
            return host
        return max(host, self.device_end - self.start)


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
        self._lock = threading.Lock()
        self._by_name: dict[str, _Form] = {}
        self._counts: dict[str, int] = {}
        self._records: deque = deque(maxlen=RECORDS)
        self._threads: dict[int, str] = {}
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._device = None         # the CUDA device whose work spans wait on
        self._anchor = None         # (event, its perf_counter_ns)
        self._pending: deque = deque()      # (record, event), record order
        self._spare: list = []      # folded events, for reuse

    # ------------------------------------------------------------ the device
    def use_device(self, device) -> None:
        """Let spans wait on ``device``'s work (a CUDA device) or on host
        work only (anything else); takes the anchor."""
        device = torch.device(device)
        with self._lock:
            self._pending.clear()
            self._spare.clear()
            self._device = device if device.type == "cuda" else None
            self._take_anchor()

    def _take_anchor(self) -> None:
        """Pin the device's event clock to ``perf_counter_ns``: an event
        recorded on an idle stream completes between the host times around
        its record and synchronize; of three tries the tightest gives the
        midpoint."""
        self._anchor = None
        if self._device is None:
            return
        stream = torch.cuda.current_stream(self._device)
        stream.synchronize()
        best = None
        for _ in range(3):
            ev = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter_ns()
            ev.record(stream)
            ev.synchronize()
            t1 = time.perf_counter_ns()
            if best is None or t1 - t0 < best[1] - best[0]:
                best = (t0, t1, ev)
        self._anchor = (best[2], (best[0] + best[1]) // 2)

    def _poll(self) -> None:
        """Fold in every span whose event has completed (under the lock)."""
        pending = self._pending
        done = []
        while pending and pending[0][1].query():
            done.append(pending.popleft())
        if not done:
            return
        now = time.perf_counter_ns()
        anchor, anchor_ns = self._anchor
        for rec, ev in done:
            dev = anchor_ns + int(anchor.elapsed_time(ev) * 1e6)
            rec.device_end = min(max(dev, rec.end), now)
            self._fold(rec)
            self._spare.append(ev)

    def _fold(self, rec: _Record) -> None:
        form = self._by_name.get(rec.name)
        if form is None:
            form = self._by_name[rec.name] = _Form(rec.name)
        form.add(rec.duration())

    @property
    def _forms(self) -> dict[str, _Form]:
        """The per-task sums, with every finished span folded in."""
        with self._lock:
            if self._pending:
                self._poll()
            return self._by_name

    # ----------------------------------------------------------------- spans
    def _thread(self):
        loc = self._local
        if not hasattr(loc, "stack"):
            loc.stack, loc.scan = [], None
            t = threading.current_thread()
            with self._lock:
                self._threads[t.ident] = t.name
        return loc

    def set_scan(self, scan: int | None) -> None:
        """The scan id that spans this thread starts from now on carry."""
        self._thread().scan = scan

    def start(self, task: str) -> None:
        t_in = time.perf_counter_ns()
        loc = self._thread()
        stack = loc.stack
        for rec in stack:
            if rec.name == task:
                raise RuntimeError(f"span '{task}' started twice")
        rec = _Record(next(self._ids), task, threading.get_ident(),
                      stack[-1].id if stack else None, loc.scan)
        if torch.autograd._profiler_enabled():
            rec.range = torch.profiler.record_function(f"span.{task}")
            rec.range.__enter__()
        if self._pending:
            with self._lock:
                self._poll()
        t_out = time.perf_counter_ns()
        for open_rec in stack:
            open_rec.excluded += t_out - t_in
        rec.start = t_out
        stack.append(rec)

    def stop(self, task: str) -> None:
        t_in = time.perf_counter_ns()
        stack = self._thread().stack
        for i in range(len(stack) - 1, -1, -1):
            if stack[i].name == task:
                rec = stack.pop(i)
                break
        else:
            raise RuntimeError(f"span '{task}' stopped without start")
        rec.end = t_in
        if rec.range is not None:
            rec.range.__exit__(None, None, None)
            rec.range = None
        with self._lock:
            self._records.append(rec)
            if self._device is None:
                self._fold(rec)
            else:
                ev = (self._spare.pop() if self._spare
                      else torch.cuda.Event(enable_timing=True))
                ev.record(torch.cuda.current_stream(self._device))
                self._pending.append((rec, ev))
                self._poll()
        t_out = time.perf_counter_ns()
        for open_rec in stack:
            open_rec.excluded += t_out - t_in

    class _Span:
        def __init__(self, ev: "RuntimeEvaluator", task: str):
            self.ev, self.task = ev, task

        def __enter__(self):
            self.ev.start(self.task)

        def __exit__(self, *exc):
            self.ev.stop(self.task)

    def span(self, task: str) -> "_Span":
        return RuntimeEvaluator._Span(self, task)

    # -------------------------------------------------------------- counters
    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def counters(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)

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

    def records(self) -> list[_Record]:
        """The kept spans, oldest first, finished device work folded in."""
        with self._lock:
            if self._pending:
                self._poll()
            return list(self._records)

    def export_spans(self, path) -> None:
        """The kept spans as a chrome-trace JSON file (chrome://tracing,
        Perfetto): one track a thread, times in microseconds of
        ``perf_counter_ns``; each event's ``dur`` runs to the later of
        its host end and its device completion."""
        recs = self.records()
        with self._lock:
            threads = dict(self._threads)
        events = [{"ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
                   "args": {"name": threads.get(tid, str(tid))}}
                  for tid in sorted({r.thread for r in recs})]
        for r in recs:
            end = r.end if r.device_end is None else max(r.end, r.device_end)
            events.append({
                "ph": "X", "cat": "span", "name": r.name, "pid": 0,
                "tid": r.thread, "ts": r.start / 1e3,
                "dur": (end - r.start) / 1e3,
                "args": {"id": r.id, "parent": r.parent, "scan": r.scan,
                         "host_end_us": r.end / 1e3,
                         "device_end_us": (None if r.device_end is None
                                           else r.device_end / 1e3)}})
        with open(path, "w") as fh:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, fh)

    def __str__(self) -> str:
        head = f"{'task':>20} | {'count':>6} | {'last':>8} | {'avg':>8} | {'run_avg':>8}\n"
        body = "".join(
            f"{r['task']:>20} | {r['count']:>6} | {r['last']:>8} | "
            f"{r['avg']:>8} | {r['run_avg']:>8}\n" for r in self.to_rows())
        return head + body

    def clear(self) -> None:
        """Forget every finished span, record and counter; re-anchor.
        Spans open now are counted when they stop."""
        with self._lock:
            self._by_name.clear()
            self._counts.clear()
            self._records.clear()
            self._pending.clear()
            self._take_anchor()
