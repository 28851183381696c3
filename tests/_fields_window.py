"""A window for the fields kernel's tests (CPU and card): full-range
values with exact zeros beside signed values and the int16 extremes, where
the parity mode's sign test and the difference nv - pv are at their
edges.  Imports no JAX."""
import numpy as np

# (x-1, x+1) values planted on planes 0 and 2 of a window, by row: the
# extremes across a sign change (where nv - pv leaves int16), a zero beside
# a signed value (no sign change), and a same-sign pair
PLANTED = ((32767, -32768), (-32768, 0), (0, 32767), (32767, 1),
           (-32767, -32768))


def planted_window(shape, seed):
    """Full-range int16 values, a third of them exactly 0, weights nonzero
    with probability 0.7; in a window of 3 planes or more, rows of planes
    0 and 2 hold ``PLANTED``'s pairs with weight, so plane 1 reads each
    across x."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-32768, 32768, shape, dtype=np.int16)
    v[rng.random(shape) < 1 / 3] = 0
    w = (rng.random(shape) < 0.7).astype(np.int16) * rng.integers(
        1, 64, shape).astype(np.int16)
    if shape[0] >= 3:
        for y in range(shape[1]):
            v[0, y], v[2, y] = PLANTED[y % len(PLANTED)]
        w[[0, 2]] = np.maximum(w[[0, 2]], 1)
    return v, w
