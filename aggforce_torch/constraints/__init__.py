"""Constraints: the set algebra of constrained site groups, and the finder
that detects rigid pairs from coordinate fluctuations."""
# ruff: noqa: F401
from .hints import Constraints
from .tools import reduce_constraint_sets, constraint_lookup_dict
from .finder import guess_pairwise_constraints
