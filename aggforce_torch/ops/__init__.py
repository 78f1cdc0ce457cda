"""Array kernels: trajectory matmuls, distances, batching, QP solves, Grams."""
# ruff: noqa: F401
from .core import trjdot, distances, qp_form, abatch
from . import torchcore
from .eqp import batched_eqp_solve_shared, eqp_solve_host
