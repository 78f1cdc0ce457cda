"""Reference-compatible alias module (torch utilities).

Mirrors the upstream ``aggforce.jaxutil`` surface (reference jaxutil.py),
the counterpart of the JAX package's ``jaxutil.py``. Canonical home:
:mod:`aggforce_torch.ops.torchcore`.
"""
# ruff: noqa: F401
from .ops.torchcore import abatch, distances, qp_form, trjdot
