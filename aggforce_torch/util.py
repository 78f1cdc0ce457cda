"""Reference-compatible alias module (numpy utilities).

Users of the upstream package import ``aggforce.util``; this module mirrors
that surface (reference util.py), as the JAX package's ``util.py`` does, so
call sites port by renaming the package only. Canonical homes:
:mod:`aggforce_torch.ops.core` and :mod:`aggforce_torch.utils.funcs`.
"""
# ruff: noqa: F401
from .ops.core import distances, trjdot
from .utils.funcs import Curry, curry, flatten
