"""Type aliases for constraint bookkeeping.

Parity target: reference constraints/hints.py:7.
"""
from typing import FrozenSet, Set

Constraints = Set[FrozenSet[int]]
