"""Chunks the global map's LRU did not hold, a window shift (the
program's ``chunk_miss`` counter over the "shift" span's count; once the
LRU is full each miss also evicts a chunk); None where the window never
shifted or the program has no counters."""
from warpsense_tpu_torch.obs.profiler import RuntimeEvaluator


def read(ctx):
    shifts = ctx["spans"].get("shift", (0, 0.0))[0]
    counters = getattr(RuntimeEvaluator.get_instance(), "counters", None)
    if shifts == 0 or counters is None:
        return None
    return counters().get("chunk_miss", 0) / shifts
