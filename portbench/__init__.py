"""The port's benchmark: see `run.py` and BENCHMARK.json at the checkout's root."""
