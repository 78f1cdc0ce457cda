"""Benchmark of ``aggforce_torch`` on one NVIDIA H100: see ``run.py``."""
