"""The share of registrations that reused the cached registration fields:
100 x ``fields_cache_hit`` / (hits + ``fields_cache_miss``), the
program's counters; None where the program has no counters."""
from warpsense_tpu_torch.obs.profiler import RuntimeEvaluator


def read(ctx):
    counters = getattr(RuntimeEvaluator.get_instance(), "counters", None)
    if counters is None:
        return None
    c = counters()
    hits, misses = c.get("fields_cache_hit", 0), c.get("fields_cache_miss", 0)
    if hits + misses == 0:
        return None
    return 100.0 * hits / (hits + misses)
