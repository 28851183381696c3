"""Arithmetic the per-layer readers of the app's spans share."""


def per_call_ms(ctx, task: str, minus=(), minus_s: float = 0.0):
    """Mean milliseconds of the app's span ``task`` a call, less the
    spans in ``minus`` and ``minus_s`` seconds; None where it never ran."""
    count, total = ctx["spans"].get(task, (0, 0.0))
    if count == 0:
        return None
    rest = sum(ctx["spans"].get(t, (0, 0.0))[1] for t in minus)
    return 1e3 * (total - rest - minus_s) / count
