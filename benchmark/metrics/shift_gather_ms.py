"""The window shift's phase "shift.gather" a shift, until its work is
done: the D2H gather (the slab's index selects and its copy to the
host); None where the window never shifted or the program has no such
span."""


def read(ctx):
    shifts = ctx["spans"].get("shift", (0, 0.0))[0]
    count, seconds = ctx["spans"].get("shift.gather", (0, 0.0))
    if shifts == 0 or count == 0:
        return None
    return 1e3 * seconds / shifts
