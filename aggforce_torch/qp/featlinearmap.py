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
by the fused device path (:mod:`aggforce_torch.qp.fusedfeat`). Every other
featurizer takes the protocol path: each site's (T, N, K) features, made on
the host by the featurizer, stream through the device in frame chunks (two
full-precision products per chunk), and each site's equality-constrained QP
is solved on the device (escalating to float64 on the host when the float32
solve is not converged) or, with ``solver_args={"backend": "host"}``, in
float64 on the host.
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
    Tuple,
    TypedDict,
    Union,
)

import numpy as np
import torch

from ..constraints import Constraints, reduce_constraint_sets
from ..map import CLAFTMap, CLAMap, LinearMap
from ..ops.eqp import converged, eqp_solve_auglag, eqp_solve_host
from ..parallel.mesh import agree_seed, as_frame_mesh
from ..trajectory import Trajectory
from ..utils.device import DeviceLike, full_fp32, resolve_device
from ..utils.prof import span
from .qplinear import DEVICE_REFINE_ITERS, SolverOptions, _host_array, _solver_opts

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


# chunk of frames processed per device call when accumulating Gram matrices
_GRAM_CHUNK: Final = 2048


@full_fp32()
def _site_gram_chunk(
    forces: torch.Tensor, feat: torch.Tensor, div: torch.Tensor, kbt: float
) -> torch.Tensor:
    """Partial Gram for one frame chunk of one cg site.

    forces: (t, N, 3); feat: (t, N, K); div: (t, K, 3). Returns (K, K). The
    force/feature contraction and the Gram product run at full float32
    precision, as the JAX twin's ``precision="highest"``.
    """
    g = torch.einsum("tja,tjk->tak", forces, feat)
    ms = g + kbt * div.transpose(1, 2)
    flat = ms.reshape(-1, ms.shape[-1])
    return torch.matmul(flat.T, flat)


@full_fp32()
def _constr_chunk(cmap_mat: torch.Tensor, feat_sub: torch.Tensor) -> torch.Tensor:
    """Constraint rows for sampled frames: (t', N, K) -> (t'*n_cg, K)."""
    rows = torch.einsum("cj,tjk->tck", cmap_mat, feat_sub)
    return rows.reshape(-1, rows.shape[-1])


def _accumulate_site(
    forces: np.ndarray,
    feat: np.ndarray,
    div: np.ndarray,
    kbt: float,
    device: torch.device,
) -> np.ndarray:
    """Stream frame chunks through ``device`` and accumulate the site Gram.

    Each chunk goes up as float32 and its partial Gram is summed in float32
    on the device; the total comes back as float64, as in the JAX package.
    """
    n_frames = forces.shape[0]
    n_chunks = max(1, -(-n_frames // _GRAM_CHUNK))
    bounds = np.linspace(0, n_frames, n_chunks + 1, dtype=int)
    gram: Optional[torch.Tensor] = None

    def up(x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)

    for lo, hi in zip(bounds[:-1], bounds[1:]):
        part = _site_gram_chunk(up(forces[lo:hi]), up(feat[lo:hi]), up(div[lo:hi]), kbt)
        gram = part if gram is None else gram + part
    return gram.cpu().numpy().astype(np.float64)


def _constr_arrays(
    features: np.ndarray,
    cg_ind: int,
    coord_map: LinearMap,
    n_frames: int,
    device: torch.device,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sampled orthogonality-constraint system (A, b) for one cg site.

    Random frames are drawn (the JAX package's ``rng.choice`` call, so one
    seed samples the same frames in both packages); each contributes n_cg
    rows demanding the feature-weighted map reproduce the coordinate-map
    row pattern e_i.
    """
    if rng is None:
        rng = np.random.default_rng()
    frame_indices = rng.choice(len(features), size=n_frames, replace=False)
    sub = torch.as_tensor(
        np.asarray(features[frame_indices]), dtype=torch.float32, device=device
    )
    cmap_mat = torch.as_tensor(
        np.asarray(coord_map.standard_matrix), dtype=torch.float32, device=device
    )
    mult = _constr_chunk(cmap_mat, sub).cpu().numpy()
    target = np.zeros((n_frames, coord_map.n_cg_sites))
    target[:, cg_ind] = 1.0
    return mult, target.reshape(-1)


def _device_site_solve(
    gram: np.ndarray,
    constr_mult: np.ndarray,
    constr_target: np.ndarray,
    opts: SolverOptions,
    device: torch.device,
) -> np.ndarray:
    """One site's QP by the float32 device solver, escalated to the float64
    host oracle when the solve is non-finite or its equilibrated constraint
    violation exceeds ``resid_tol`` (NaN-aware)."""

    def up(x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    params_dev, resid = eqp_solve_auglag(
        up(gram),
        up(constr_mult),
        up(constr_target[:, None]),
        delta=opts.get("delta", 1e-6),
        iters=opts.get("refine_iters", DEVICE_REFINE_ITERS),
        return_resid=True,
    )
    # one host fetch of solution and diagnostic
    fetched = torch.cat([params_dev[:, 0], resid.reshape(1)]).cpu().numpy()
    params, resid_v = fetched[:-1], float(fetched[-1])
    if not converged(resid_v, opts.get("resid_tol", 1e-4), params):
        # f32 conditioning failure (non-finite, or finite but unconverged
        # past tolerance): retry with the f64 oracle
        params = eqp_solve_host(gram, constr_mult, constr_target[:, None])[:, 0]
    return params


@span("aggforce.entry")
def qp_feat_linear_map(
    traj: Trajectory,
    coord_map: LinearMap,
    featurizer: GeneralizedFeaturizer,
    kbt: float,
    n_constraint_frames: int = 20,
    constraints: Optional[Constraints] = None,
    sparse: bool = True,  # noqa: ARG001 - accepted for reference compatibility
    solver_args: Optional[Union[SolverOptions, dict]] = None,
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
    case (``allow_fused=False``, any other featurizer, or a ``backend`` in
    ``solver_args``) is the protocol path: the featurizer runs on the host
    coordinates, each site's Gram is accumulated on ``device`` in frame
    chunks, and each site's QP is solved there in float32 ("device", the
    default) or on the host in float64 ("host").

    ``mesh`` (``parallel.make_mesh``) shards the fused fit's frame axis over
    the ranks; the protocol path fits every frame on each rank, as the JAX
    package's ignores the mesh (a ``mesh`` that is not one still raises).
    Its constraint frames are drawn from rank 0's seed when
    ``constraint_rng`` is None, so every rank returns the same map.
    """
    if mesh is not None:
        mesh = as_frame_mesh(mesh)
    if constraints is None:
        constraints = set()
    opts = _solver_opts(dict(solver_args) if solver_args else None)

    if allow_fused and opts.get("backend", "auto") == "auto":
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

    if mesh is not None and constraint_rng is None:
        constraint_rng = np.random.default_rng(agree_seed(mesh, None))
    dev = resolve_device(device, traj.coords, traj.forces)
    forces = _host_array(traj.forces)
    feat_results = featurizer(_host_array(traj.coords), coord_map, constraints)
    feats = feat_results[KNAME_FEATS]
    divs = feat_results[KNAME_DIVS]
    names = feat_results[KNAME_NAMES]

    backend = opts.get("backend", "auto")
    if backend == "auto":
        backend = "device"

    per_site_coef: List[np.ndarray] = []
    for ind, (feat, div) in enumerate(zip(feats, divs)):
        constr_mult, constr_target = _constr_arrays(
            features=feat,
            cg_ind=ind,
            coord_map=coord_map,
            n_frames=n_constraint_frames,
            device=dev,
            rng=constraint_rng,
        )
        gram = _accumulate_site(forces, feat, div, kbt, dev)
        if l2_regularization > 0:
            gram = gram + l2_regularization * np.eye(gram.shape[0])
        if backend == "host":
            params = eqp_solve_host(
                gram,
                constr_mult,
                constr_target[:, None],
                delta=opts.get("delta", 1e-12),
                refine_iters=opts.get("refine_iters", 4),
            )[:, 0]
        else:
            params = _device_site_solve(gram, constr_mult, constr_target, opts, dev)
        if not np.all(np.isfinite(params)):
            raise ValueError("Map optimization failed.")
        per_site_coef.append(params)

    force_map = _feat_linear_mapping(
        featurizer=featurizer,
        coefs=per_site_coef,
        mapping=coord_map,
        constraints=constraints,
        kbt=kbt,
        tags={"feat_names": names, "coef_list": per_site_coef},
    )
    return CLAFTMap(coord_map=coord_map, force_map=force_map)


def _feat_linear_mapping(
    featurizer: GeneralizedFeaturizer,
    coefs: List[np.ndarray],
    mapping: LinearMap,
    constraints: Constraints,
    kbt: float = 1.0,
    **kwargs,
) -> CLAMap:
    """Package per-site feature coefficients as a CLAMap.

    The returned map re-runs the featurizer on new coordinates at apply time:
    scale weights are feature/coefficient contractions, translations come
    from the kbt-scaled divergence term.

    The optimization objective contains the divergence as ``kbt * div``
    (reference qp/featlinearmap.py:361-368), so the applied map carries the
    same scaling, as in the JAX package; the reference's apply path drops
    the kbt factor (reference qp/featlinearmap.py:492-495), which is
    inconsistent with its own fit objective.
    """

    def scale_f(copoints: np.ndarray) -> np.ndarray:
        feats = featurizer(copoints, mapping, constraints)[KNAME_FEATS]
        weights = [np.einsum("...jk,k->...j", f, c) for f, c in zip(feats, coefs)]
        return np.stack(weights, axis=1)

    def trans_f(copoints: np.ndarray) -> np.ndarray:
        divs = featurizer(copoints, mapping, constraints)[KNAME_DIVS]
        weights = [
            kbt * np.einsum("tka,k->ta", d, c) for d, c in zip(divs, coefs)
        ]
        return np.stack(weights, axis=1)

    return CLAMap(
        scale=scale_f,
        trans=trans_f,
        n_fg_sites=mapping.n_fg_sites,
        zeroes_check=True,
        **kwargs,
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
