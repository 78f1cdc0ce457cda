"""Constraint-set algebra.

The constraint finder (``guess_pairwise_constraints``) is not ported yet
(ROADMAP Queue 1 item 6), so this package holds only the set algebra.
"""
# ruff: noqa: F401
from .hints import Constraints
from .tools import reduce_constraint_sets, constraint_lookup_dict
