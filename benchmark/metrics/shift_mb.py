"""Megabytes a window shift moves between the card and the host, both
ways (the program's ``shift_bytes_d2h`` + ``shift_bytes_h2d`` counters
over the "shift" span's count); None where the window never shifted or
the program has no counters."""
from warpsense_tpu_torch.obs.profiler import RuntimeEvaluator


def read(ctx):
    shifts = ctx["spans"].get("shift", (0, 0.0))[0]
    counters = getattr(RuntimeEvaluator.get_instance(), "counters", None)
    if shifts == 0 or counters is None:
        return None
    c = counters()
    if "shift_bytes_d2h" not in c:
        return None
    return (c["shift_bytes_d2h"] + c.get("shift_bytes_h2d", 0)) / 1e6 / shifts
