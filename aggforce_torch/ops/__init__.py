"""Array kernels: trajectory matmuls, distances, batching, QP solves, Grams."""
# ruff: noqa: F401
from .core import trjdot, distances, qp_form, abatch
from . import torchcore
from .eqp import (
    eqp_solve_auglag,
    eqp_solve_host,
    batched_eqp_solve_auglag,
    batched_eqp_solve_shared,
)
