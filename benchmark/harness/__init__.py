"""The harness of ``benchmark/run.py``: cells, seeded data, the measured
window, the profiler's reading and the comparison that decides
``correct``."""
