"""The window shift's phase "shift.store" a shift, until its work is
done: ``pack`` and the global map's chunk writes, with the LRU's
evictions; None where the window never shifted or the program has no
such span."""


def read(ctx):
    shifts = ctx["spans"].get("shift", (0, 0.0))[0]
    count, seconds = ctx["spans"].get("shift.store", (0, 0.0))
    if shifts == 0 or count == 0:
        return None
    return 1e3 * seconds / shifts
