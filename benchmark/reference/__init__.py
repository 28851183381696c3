"""Plain reference of the program's per-scan step (imports nothing of it)."""
