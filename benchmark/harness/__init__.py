"""The benchmark harness of laghos_tpu_torch (see benchmark/run.py)."""
