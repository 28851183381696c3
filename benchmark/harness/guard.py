"""The check that no JAX and nothing of the JAX package was loaded."""
from __future__ import annotations

import sys

FOREIGN = ("jax", "jaxlib", "flax", "warpsense_tpu")


def foreign_modules(modules=None) -> list:
    """Top-level names (whole, before the first dot) of loaded modules
    that belong to JAX or to the JAX package; ``warpsense_tpu_torch`` is
    not one of them."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".", 1)[0] for n in names} & set(FOREIGN))
