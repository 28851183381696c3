"""The card's idle share of the traced window: 100 x (1 - the union of
the device operations' intervals over the window), the benchmark's own
probes left out of both."""


def read(ctx):
    if ctx["window_s"] <= 0 or ctx["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
