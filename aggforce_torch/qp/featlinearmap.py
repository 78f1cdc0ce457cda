r"""Featurized (configuration-dependent) force-map optimization: protocol layer.

Counterpart of the JAX package's ``qp/featlinearmap.py``. Behavior parity
targets: reference qp/featlinearmap.py:249-394 (``qp_feat_linear_map``),
:553-627 (``id_feat``), :73-246 (``FeatZipper``), :630-745
(``multifeaturize`` / ``Multifeaturize``).

The optimization: per cg site i, find coefficients c_i minimizing

    sum_{t,a} ( sum_j F[t,j,a] feat_i[t,j,k] c_k  +  kbt * div_i[t,k,a] c_k )^2
        + l2 * |c_i|^2
    s.t.  (M feat_i[t'] c_i) = e_i   for sampled frames t'

The canonical featurizer (``Multifeaturize([id_feat, gb_feat])``) is fitted
by the fused device path (:mod:`aggforce_torch.qp.fusedfeat`). The generic
featurizer protocol path (per-site feature arrays through the solver) is not
ported yet (ROADMAP Queue 1 item 4) and raises.
"""

from typing import (
    Any,
    Callable,
    ClassVar,
    Dict,
    Final,
    Generator,
    Iterable,
    List,
    Optional,
    TypedDict,
    Union,
)

import numpy as np

from ..constraints import Constraints, reduce_constraint_sets
from ..map import CLAFTMap, LinearMap
from ..trajectory import Trajectory
from ..utils.device import DeviceLike

KNAME_FEATS: Final = "feats"
KNAME_DIVS: Final = "divs"
KNAME_NAMES: Final = "names"


class Features(TypedDict):
    """Featurizer output: per-cg-site feature and divergence arrays."""

    feats: Iterable[np.ndarray]
    divs: Iterable[np.ndarray]
    names: Union[Iterable[str], None]


Featurizer = Callable[[np.ndarray, LinearMap, Constraints], Features]
GeneralizedFeatures = Union[Features, "FeatZipper"]
GeneralizedFeaturizer = Union[
    Callable[[np.ndarray, LinearMap, Constraints], Union[Features, "FeatZipper"]],
    Featurizer,
]


class FeatZipper:
    """Lazily concatenates the output of multiple featurizers.

    Indexing with "feats"/"divs" yields generators whose items concatenate the
    corresponding per-site arrays from every content dict along the feature
    axis; laziness means at most one cg site's combined tensor is live at a
    time. Sources are consumed as iteration proceeds (one-shot semantics,
    like the reference).
    """

    generator_keys: ClassVar[frozenset] = frozenset([KNAME_FEATS, KNAME_DIVS])
    name_key: ClassVar[str] = KNAME_NAMES

    joiners: ClassVar[Dict[str, Callable]] = {
        KNAME_FEATS: lambda args: np.concatenate(args, axis=2),
        KNAME_DIVS: lambda args: np.concatenate(args, axis=1),
    }

    def __init__(self, content: List[GeneralizedFeatures]) -> None:
        """Store featurizer outputs to aggregate."""
        self.reset(content)
        self.names = None

    def keys(self) -> frozenset:
        """All valid indexing keys."""
        return self.generator_keys.union(frozenset([KNAME_NAMES]))

    def reset(self, content: Iterable[GeneralizedFeatures]) -> None:
        """(Re)bind the zipped per-key source iterators."""
        self.source = {
            key: zip(*[c[key] for c in content]) for key in self.generator_keys
        }

    def _makegenerator(self, key: str) -> Generator[np.ndarray, None, None]:
        joiner = self.joiners[key]
        for items in self.source[key]:
            yield joiner(items)

    def __getitem__(self, key: str):
        """Return the aggregating generator for a key ("names" returns None)."""
        if key in self.generator_keys:
            return self._makegenerator(key)
        if key == KNAME_NAMES:
            return self.names
        raise KeyError(f"Invalid key; valid keys are {self.keys()}")


def qp_feat_linear_map(
    traj: Trajectory,
    coord_map: LinearMap,
    featurizer: GeneralizedFeaturizer,
    kbt: float,
    n_constraint_frames: int = 20,
    constraints: Optional[Constraints] = None,
    sparse: bool = True,  # noqa: ARG001 - accepted for reference compatibility
    solver_args: Optional[dict] = None,
    l2_regularization: float = 1e1,
    constraint_rng: Optional[np.random.Generator] = None,
    allow_fused: bool = True,
    mesh=None,
    device: DeviceLike = None,
) -> CLAFTMap:
    """Optimize a force map linear in user-provided configuration features.

    Signature mirrors the reference (qp/featlinearmap.py:249) and the JAX
    package; ``sparse`` is accepted but ignored, and ``constraint_rng``
    allows deterministic constraint-frame sampling. ``device`` (default:
    the GPU) is where the fit runs.

    The canonical id+gb featurizer, with no explicit solver backend in
    ``solver_args``, is fitted by the fused device path
    (:func:`aggforce_torch.qp.fusedfeat.fused_gb_linear_map`). Every other
    case is the generic protocol path, which is not ported yet and raises
    NotImplementedError.
    """
    if constraints is None:
        constraints = set()
    backend = (solver_args or {}).get("backend", "auto")

    if allow_fused and backend == "auto":
        from .fusedfeat import fused_gb_linear_map, recognize_canonical_featurizer

        spec = recognize_canonical_featurizer(featurizer)
        if spec is not None:
            return fused_gb_linear_map(
                traj,
                coord_map,
                kbt=kbt,
                spec=spec,
                constraints=constraints,
                n_constraint_frames=n_constraint_frames,
                l2_regularization=l2_regularization,
                constraint_rng=constraint_rng,
                mesh=mesh,
                device=device,
            )
    raise NotImplementedError(
        "only the canonical Multifeaturize([id_feat, Curry(gb_feat, ...)]) "
        "featurizer with the default solver is ported; the generic featurizer "
        "protocol path waits for ROADMAP Queue 1 item 4"
    )


def id_feat(
    points: np.ndarray,
    cmap: LinearMap,
    constraints: Constraints,
    return_ids: bool = False,
) -> Union[np.ndarray, Features]:
    """One-hot per-site label features (labels shared within constraint groups).

    With ``return_ids=True`` returns the (n_fg_sites,) int32 label array
    instead (used by other featurizers to allocate channels respecting
    constraints). Features are frame-independent, so divergences are zero and
    every cg site shares views of the same arrays.
    """
    groups = set(constraints) | {frozenset([x]) for x in range(cmap.n_fg_sites)}
    reduced = sorted(reduce_constraint_sets(groups), key=min)

    if return_ids:
        ids = np.zeros(cmap.n_fg_sites, dtype=np.int32)
        for label, members in enumerate(reduced):
            ids[sorted(members)] = label
        return ids

    n_frames = points.shape[0]
    n_types = len(reduced)
    feats = np.zeros((n_frames, cmap.n_fg_sites, n_types), dtype=np.float32)
    for label, members in enumerate(reduced):
        feats[:, sorted(members), label] = 1.0
    divs = np.zeros((n_frames, n_types, cmap.n_dim), dtype=np.float32)
    return {
        KNAME_FEATS: [feats] * cmap.n_cg_sites,
        KNAME_DIVS: [divs] * cmap.n_cg_sites,
        KNAME_NAMES: None,
    }


def multifeaturize(featurizers: List[GeneralizedFeaturizer]) -> GeneralizedFeaturizer:
    """Functional combinator: run all featurizers, zip their outputs lazily."""

    def composite(
        copoints: np.ndarray, coord_map: LinearMap, constraints: Constraints
    ) -> GeneralizedFeatures:
        return FeatZipper([f(copoints, coord_map, constraints) for f in featurizers])

    return composite


class Multifeaturize:
    """Self-describing object form of :func:`multifeaturize`."""

    def __init__(self, featurizers: Iterable[GeneralizedFeaturizer]) -> None:
        """Store the featurizers to combine."""
        self.featurizers = featurizers

    def __call__(self, *args: Any, **kwargs: Any) -> GeneralizedFeatures:
        """Evaluate every featurizer and wrap the outputs in a FeatZipper."""
        return FeatZipper([f(*args, **kwargs) for f in self.featurizers])

    def __repr__(self) -> str:
        inner = " ".join(
            f"C{i}: {f!r}" for i, f in enumerate(self.featurizers)
        )
        return f"{self.__class__.__name__}(): {inner}"

    def __str__(self) -> str:
        lines = [f"{self.__class__.__name__} instance:"]
        for i, f in enumerate(self.featurizers):
            lines.append(f"  Callable {i}:")
            lines.extend("    " + ln for ln in str(f).split("\n"))
        return "\n".join(lines)
