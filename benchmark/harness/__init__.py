"""The benchmark harness of warpsense_tpu_torch (see benchmark/run.py)."""
