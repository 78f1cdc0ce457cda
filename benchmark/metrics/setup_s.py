"""Seconds from the process's start to the window's start: imports, CUDA
context, kernel loading (or the first build), the pool made on the card and
the warm fit."""


def read(run):
    return run.setup_s if run.setup_s > 0 else None
