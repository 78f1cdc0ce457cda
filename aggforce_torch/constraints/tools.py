"""Constraint-set algebra: merge to disjoint groups, anchor lookup.

Behavior parity targets: reference constraints/tools.py:7-77
(``reduce_constraint_sets``) and :80-116 (``constraint_lookup_dict``). The
reference uses an ad-hoc flood merge it itself flags as unproven; here the
merge is a standard union-find, which is provably correct and O(n alpha(n)).
"""

from typing import Dict, FrozenSet, Iterable, List

from .hints import Constraints


class _UnionFind:
    """Path-compressing union-find over arbitrary hashable items."""

    def __init__(self) -> None:
        self.parent: Dict[int, int] = {}

    def find(self, a: int) -> int:
        root = a
        while self.parent.setdefault(root, root) != root:
            root = self.parent[root]
        while self.parent[a] != root:
            self.parent[a], a = root, self.parent[a]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def reduce_constraint_sets(constraints: Iterable[FrozenSet[int]]) -> Constraints:
    """Merge overlapping constraint groups into disjoint groups.

    {{1,2},{2,3},{4,5}} -> {{1,2,3},{4,5}}: any two groups sharing a member are
    unioned transitively, since shared holonomic constraints force shared
    mapping coefficients across the whole connected component.
    """
    uf = _UnionFind()
    members: List[FrozenSet[int]] = [frozenset(c) for c in constraints]
    for group in members:
        it = iter(group)
        try:
            first = next(it)
        except StopIteration:
            continue
        for other in it:
            uf.union(first, other)
    clusters: Dict[int, set] = {}
    for group in members:
        for site in group:
            clusters.setdefault(uf.find(site), set()).add(site)
    return {frozenset(v) for v in clusters.values()}


def constraint_lookup_dict(constraints: Constraints) -> Dict[int, int]:
    """Map each non-anchor member of every group to the group's smallest index.

    {{1,2,3},{4,5}} -> {2:1, 3:1, 5:4}. Used when building the coefficient
    duplication matrix for constrained QPs.
    """
    out: Dict[int, int] = {}
    for group in constraints:
        ordered = sorted(group)
        anchor = ordered[0]
        for member in ordered[1:]:
            out[member] = anchor
    return out
