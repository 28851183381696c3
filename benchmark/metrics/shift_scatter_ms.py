"""The window shift's phase "shift.scatter" a shift, until its work is
done: the H2D scatter (the copy to the device and the indexed write);
None where the window never shifted or the program has no such span."""


def read(ctx):
    shifts = ctx["spans"].get("shift", (0, 0.0))[0]
    count, seconds = ctx["spans"].get("shift.scatter", (0, 0.0))
    if shifts == 0 or count == 0:
        return None
    return 1e3 * seconds / shifts
