"""Gaussian conditional-noise augmenters (numpy and torch).

Counterpart of the JAX package's ``trajectory/gaussian.py``. Behavior parity
targets: reference trajectory/simplegausstraj.py:13-137 (SimpleCondNormal:
isotropic noise with closed-form log-gradients) and
trajectory/jaxgausstraj.py:99-402 (the conditional normal
g(y|x) = N(y; premap(x), E) with optional source_postmap, sampling,
astype/downcast helpers), here :class:`TCondNormal`.

As in the JAX package, the math avoids the dense multivariate-normal logpdf:

  * scalar covariance uses the closed form  grad_y log g = -(y - Ax)/var  and
    samples y = Ax + sqrt(var) * eps with eps ~ N(0, I);
  * grad_x log g = A^T (y - Ax)/var: the transpose of a linear premap, or
    one VJP (``torch.func.vjp``) through a premap callable;
  * full-matrix covariance keeps a Cholesky-based path.

Every function below that draws takes the standard-normal draw ``eps`` as an
argument; only :class:`TCondNormal` draws, from an explicit
``torch.Generator`` made on the device of the draw and seeded from ``seed``.
Torch's generators cannot reproduce JAX's PRNG keys (and a CUDA generator's
stream differs from a CPU generator's), so a seed gives the same draws as
another torch run on the same kind of device, not as JAX; feeding JAX's draw
to these functions reproduces JAX's numbers.
"""

from typing import Callable, Dict, Final, Optional, Tuple, TypeVar, Union

import numpy as np
import torch
from numpy.typing import DTypeLike

from ..ops.torchcore import trjdot
from ..utils.device import DeviceLike, full_fp32, resolve_device
from .augment import Augmenter

_UNSET: Final = object()

A = TypeVar("A")


def _ident(x: A, /) -> A:
    """Identity map."""
    return x


def _is_close_to_ident(c: Callable) -> bool:
    """Best-effort check that a callable is the identity."""
    from ..map import LinearMap  # local import avoids a circular dependency

    if isinstance(c, LinearMap):
        return c.close_to_identity()
    return c is _ident


def _linear_flatcall_matrix(premap: Callable) -> Optional[Tuple[object, bool]]:
    """(LinearMap, NaN-fill flag) behind a bound ``LinearMap.flat_call``.

    A linear premap is applied as its matrix, so its VJP is the transpose
    and no autodiff runs. The fill flag carries the map's ``handle_nans``
    semantics: a NaN-handling map applies to NaN->0-filled input (with
    ``bypass_nan_check`` merely skipping the raise). Returns None when the
    map would RAISE on NaNs (checking without bypass): that verdict stays
    with the callable, which then takes the VJP path.
    """
    from ..map import LinearMap  # local import avoids a circular dependency

    owner = getattr(premap, "__self__", None)
    if owner is None or not isinstance(owner, LinearMap):
        return None
    if getattr(premap, "__func__", None) is not LinearMap.flat_call:
        return None
    if owner.handle_nans and not getattr(owner, "bypass_nan_check", False):
        return None
    return owner, bool(owner.handle_nans)


def _linear_map_matrix(postmap: Callable) -> Optional[Tuple[object, bool]]:
    """(LinearMap, NaN-fill flag) of a LinearMap source_postmap."""
    from ..map import LinearMap

    if not isinstance(postmap, LinearMap):
        return None
    if postmap.handle_nans and not getattr(postmap, "bypass_nan_check", False):
        return None
    return postmap, bool(postmap.handle_nans)


def _map_tensor(lmap, device: torch.device, dtype: torch.dtype) -> Optional[torch.Tensor]:
    """A LinearMap's standard matrix on ``device`` (memoized for TLinearMaps);
    None for None (the identity)."""
    if lmap is None:
        return None
    memo = getattr(lmap, "torch_standard_matrix", None)
    if memo is not None:
        return memo(device, dtype)
    return torch.as_tensor(
        np.asarray(lmap.standard_matrix), dtype=dtype, device=device
    ).contiguous()


def _torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of ``x`` in ``like``'s dtype and device."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _nan_fill(x: torch.Tensor) -> torch.Tensor:
    """``x`` with NaN (only NaN: inf propagates) replaced by 0."""
    return torch.where(torch.isnan(x), 0.0, x)


class SimpleCondNormal(Augmenter):
    """Isotropic Gaussian noiser with closed-form log-gradients (numpy).

    A copy of the JAX package's class: seeded draws equal its draws.
    """

    def __init__(
        self,
        var: float,
        seed: Optional[int] = None,
        dtype: Union[DTypeLike, object] = _UNSET,
    ) -> None:
        """Initialize with noise variance ``var`` and an optional RNG seed."""
        self.var = var
        self._rng = np.random.default_rng(seed)
        if dtype is _UNSET:
            self.dtype: np.dtype = np.dtype(np.float32)
        else:
            self.dtype = np.dtype(dtype)  # type: ignore[arg-type]

    def sample(self, source: np.ndarray) -> np.ndarray:
        """Return source + sqrt(var) * standard normal noise."""
        noise = np.sqrt(self.var) * self._rng.standard_normal(
            source.shape, dtype=self.dtype
        )
        return (source + noise).astype(self.dtype, copy=False)

    def log_gradient(
        self, source: np.ndarray, generated: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Closed-form gradients: (+(y-x)/var, -(y-x)/var)."""
        d_gen = (-(generated - source) / self.var).astype(self.dtype, copy=False)
        return -d_gen, d_gen

    def astype(self, dtype: DTypeLike, *args, **kwargs) -> "SimpleCondNormal":  # noqa: ARG002
        """Return an instance emitting the requested dtype."""
        return self.__class__(var=self.var, dtype=dtype)


def make_generator(seed: int, device: torch.device) -> torch.Generator:
    """The torch generator of an augmenter seeded with ``seed``, on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def _standard_normal(
    gen: torch.Generator, shape, device: torch.device, dtype: torch.dtype
) -> torch.Tensor:
    """The standard-normal draw of every augmentation (one call per draw)."""
    return torch.randn(shape, generator=gen, device=device, dtype=dtype)


def _scalar_lgrads(
    flat_source: torch.Tensor,
    flat_generated: torch.Tensor,
    var: torch.Tensor,
    premap: Callable[[torch.Tensor], torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form log-gradients for diagonal covariance via one VJP."""
    means, vjp = torch.func.vjp(premap, flat_source)
    resid = (flat_generated - means) / var
    (source_grad,) = vjp(resid)
    return source_grad, -resid


def _matrix_lgrads(
    flat_source: torch.Tensor,
    flat_generated: torch.Tensor,
    chol: torch.Tensor,
    premap: Callable[[torch.Tensor], torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Log-gradients for full covariance: solve E w = (y - Ax) via Cholesky."""
    means, vjp = torch.func.vjp(premap, flat_source)
    resid = flat_generated - means
    w = torch.cholesky_solve(resid.T, chol).T
    (source_grad,) = vjp(w)
    return source_grad, -w


def _apply_pmat(coords: torch.Tensor, pmat: Optional[torch.Tensor], pfill: bool):
    """Premap application matching LinearMap NaN-fill semantics.

    A handle_nans map acts on NaN->0-filled input (the fill happens even
    under bypass_nan_check, which only skips the raise); its VJP is
    therefore zero at NaN input positions. Returns (means, vjp_mask) where
    vjp_mask is None when no masking is needed.
    """
    if pmat is None:
        return coords, None
    if pfill:
        return trjdot(_nan_fill(coords), pmat), torch.isnan(coords)
    return trjdot(coords, pmat), None


def _mat_sample(
    eps: torch.Tensor,  # (T, C*3) standard-normal draw
    coords: torch.Tensor,  # (T, N, 3)
    var: torch.Tensor,
    pmat: Optional[torch.Tensor],  # (C, N) site matrix, or None = identity
    pfill: bool = False,
) -> torch.Tensor:
    """Scalar-covariance sample y = premap(x) + sqrt(var) * eps."""
    means, _ = _apply_pmat(coords, pmat, pfill)
    return means + torch.sqrt(var) * eps.reshape(means.shape)


def _mat_lgrads(
    coords: torch.Tensor,
    generated: torch.Tensor,
    var: torch.Tensor,
    pmat: Optional[torch.Tensor],
    pfill: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form scalar-covariance log-gradients, linear premap as a matrix.

    grad_y log g = -(y - Mx)/var; grad_x log g = M^T (y - Mx)/var (the VJP
    of a linear premap is its transpose, zeroed at filled NaN inputs).
    """
    means, mask = _apply_pmat(coords, pmat, pfill)
    resid = (generated - means) / var
    src = resid if pmat is None else trjdot(resid, pmat.T)
    if mask is not None:
        src = torch.where(mask, 0.0, src)
    return src, -resid


def _mat_matrix_lgrads(
    coords: torch.Tensor,
    generated: torch.Tensor,
    chol: torch.Tensor,
    pmat: Optional[torch.Tensor],
    pfill: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-covariance log-gradients, linear premap as a matrix."""
    means, mask = _apply_pmat(coords, pmat, pfill)
    t, c, d = means.shape
    resid = (generated - means).reshape(t, c * d)
    w3 = torch.cholesky_solve(resid.T, chol).T.reshape(t, c, d)
    src = w3 if pmat is None else trjdot(w3, pmat.T)
    if mask is not None:
        src = torch.where(mask, 0.0, src)
    return src, -w3


def _fused_augment_math(
    eps: torch.Tensor,  # (T, C*3) standard-normal draw
    coords: torch.Tensor,  # (T, N, 3)
    forces: torch.Tensor,  # (T, N, 3)
    var: torch.Tensor,
    kbt: torch.Tensor,
    pmat: Optional[torch.Tensor],
    postmat: Optional[torch.Tensor],
    pfill: bool = False,
    postfill: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The extended arrays ([x | y], [f + kbt*grad_x log g | kbt*grad_y log g])
    of one augmentation, from its draw ``eps``."""
    means, mask = _apply_pmat(coords, pmat, pfill)
    eps3 = eps.reshape(means.shape)
    sd = torch.sqrt(var)
    aug_coords = means + sd * eps3
    resid = (sd / var) * eps3  # (y - mean)/var
    src = resid if pmat is None else trjdot(resid, pmat.T)
    if mask is not None:
        src = torch.where(mask, 0.0, src)
    if postmat is not None:
        if postfill:
            src = _nan_fill(src)
        src = trjdot(src, postmat)
    full_coords = torch.cat([coords, aug_coords], dim=1)
    full_forces = torch.cat([forces + kbt * src, -kbt * resid], dim=1)
    return full_coords, full_forces


def _mat_fused_apply(
    eps: torch.Tensor,
    coords: torch.Tensor,  # (T, N, 3)
    forces: torch.Tensor,  # (T, N, 3)
    var: torch.Tensor,
    kbt: torch.Tensor,
    pmat: Optional[torch.Tensor],
    postmat: Optional[torch.Tensor],
    cmat: torch.Tensor,  # (C_out, N_aug) coordinate map over the extended system
    fmat: torch.Tensor,  # (C_out, N_aug) force map over the extended system
    fill_c: bool,
    fill_f: bool,
    pfill: bool = False,
    postfill: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Augment, map, and compute both participation-masked NaN verdicts
    (the semantics of ``map.torchlinear._checked_trjdot``) without a host
    sync. ``fill_c``/``fill_f`` mirror each map's ``handle_nans``: when
    False, NaNs propagate into the mapped output."""
    full_c, full_f = _fused_augment_math(
        eps, coords, forces, var, kbt, pmat, postmat, pfill, postfill
    )
    verdicts = []
    mapped = []
    for full, mat, fill in ((full_c, cmat, fill_c), (full_f, fmat, fill_f)):
        if fill:
            nan = torch.isnan(full)
            part = torch.any(mat != 0.0, dim=0)
            verdicts.append(torch.any(nan & part[None, :, None]))
            mapped.append(trjdot(torch.where(nan, 0.0, full), mat))
        else:
            verdicts.append(torch.zeros((), dtype=torch.bool, device=full.device))
            mapped.append(trjdot(full, mat))
    return mapped[0], mapped[1], verdicts[0], verdicts[1]


class TCondNormal(Augmenter):
    r"""Gaussian augmenter g(y|x) = N(y; premap(x), E) on torch tensors.

    ``premap`` consumes/produces *flattened* (n_frames, n_sites*n_dim) arrays
    (typically a ``TLinearMap.flat_call``); its output dimension fixes the
    number of virtual particles. ``source_postmap`` is applied to the
    unflattened source log-gradient — used by staged maps to express
    already-coarse-grained force corrections.

    Public methods are type-preserving: numpy in -> numpy out (computed on
    ``device``, default the GPU, in the augmenter's dtype), tensor in ->
    tensor out (on the tensor's device, in float64 when the tensor or the
    augmenter is float64, else float32). Every draw comes from a
    ``torch.Generator`` on the device of the draw, seeded from ``seed``
    (drawn from numpy when None) and advanced by each draw.
    """

    n_dim: Final = 3

    def __init__(
        self,
        cov: Union[float, np.ndarray, torch.Tensor],
        premap: Optional[Callable] = None,
        source_postmap: Optional[Callable] = None,
        seed: Optional[int] = None,
        dtype: Union[DTypeLike, object] = _UNSET,
        device: DeviceLike = None,
    ) -> None:
        """Initialize.

        ``cov`` may be a positive scalar (isotropic diagonal covariance; fast
        closed-form path) or a full (D, D) matrix. With a scalar, the ``cov``
        attribute stays None until the first draw reveals D, mirroring the
        reference's deferred construction.
        """
        self.premap = _ident if premap is None else premap
        self.source_postmap = _ident if source_postmap is None else source_postmap
        pm = _linear_flatcall_matrix(self.premap)
        self._premap_map, self._premap_fill = pm if pm else (None, False)
        qm = _linear_map_matrix(self.source_postmap)
        self._postmap_map, self._postmap_fill = qm if qm else (None, False)
        self.device = resolve_device(device)
        if seed is None:
            seed = int(np.random.default_rng().integers(0, int(1e6)))
        self.seed = int(seed)
        self._gens: Dict[torch.device, torch.Generator] = {}
        self._cov = cov
        self._chols: Dict[Tuple[torch.device, torch.dtype], torch.Tensor] = {}
        self.cov: Optional[torch.Tensor] = (
            torch.as_tensor(cov) if not self._scalar_cov else None
        )
        if dtype is _UNSET:
            self.dtype = (
                np.dtype(cov.dtype) if isinstance(cov, np.ndarray) else np.dtype(np.float32)
            )
        else:
            self.dtype = np.dtype(dtype)  # type: ignore[arg-type]

    @property
    def _scalar_cov(self) -> bool:
        return np.ndim(self._cov) != 2

    def _draw(self, n_frames: int, width: int, like: torch.Tensor) -> torch.Tensor:
        """One (n_frames, width) standard-normal draw, in the flattened layout
        both the fused and the piecewise augmentation use, from the generator
        of ``like``'s device (seeded on first use)."""
        if like.device not in self._gens:
            self._gens[like.device] = make_generator(self.seed, like.device)
        return _standard_normal(
            self._gens[like.device], (n_frames, width), like.device, like.dtype
        )

    def _linear_draw(self, src: torch.Tensor):
        """(premap matrix or None, the draw of one augmentation of ``src``)
        for a linear or identity premap."""
        pmat = _map_tensor(self._premap_map, src.device, src.dtype)
        n_gen = src.shape[1] if pmat is None else pmat.shape[0]
        return pmat, self._draw(src.shape[0], n_gen * self.n_dim, src)

    def _inputs(self, *arrays) -> Tuple[bool, Tuple[torch.Tensor, ...]]:
        """(tensor input?, the arrays as tensors in the compute dtype)."""
        tensor_in = any(isinstance(a, torch.Tensor) for a in arrays)
        own = _torch_dtype(self.dtype)
        if tensor_in:
            device = next(a.device for a in arrays if isinstance(a, torch.Tensor))
            f64 = own == torch.float64 or any(
                isinstance(a, torch.Tensor) and a.dtype == torch.float64 for a in arrays
            )
            dtype = torch.float64 if f64 else torch.float32
        else:
            device, dtype = self.device, own
        return tensor_in, tuple(
            torch.as_tensor(a, device=device).to(dtype) for a in arrays
        )

    def _out(self, x: torch.Tensor, tensor_in: bool):
        return x if tensor_in else x.cpu().numpy().astype(self.dtype, copy=False)

    def _matrix_ok(self) -> bool:
        """Whether the premap and postmap can enter the matrix kernels."""
        return (self.premap is _ident or self._premap_map is not None) and (
            self.source_postmap is _ident or self._postmap_map is not None
        )

    def _set_cov(self, n_generated_sites: int, like: torch.Tensor) -> None:
        """Materialize the diagonal covariance attribute for API parity."""
        if self.cov is None:
            d = n_generated_sites * self.n_dim
            self.cov = torch.diag(
                torch.full((d,), float(self._cov), dtype=like.dtype, device=like.device)
            )

    def _cholesky(self, like: torch.Tensor) -> torch.Tensor:
        key = (like.device, like.dtype)
        if key not in self._chols:
            cov = torch.as_tensor(self._cov, device=like.device).to(like.dtype)
            self._chols[key] = torch.linalg.cholesky(cov)
        return self._chols[key]

    @full_fp32()
    def sample(self, source):
        """Draw one set of virtual coordinates conditioned on ``source``."""
        tensor_in, (src,) = self._inputs(source)
        if src.ndim != 3 or src.shape[-1] != self.n_dim:
            raise ValueError(f"Expected (*, *, {self.n_dim}) array; got {tuple(src.shape)}.")
        if self._scalar_cov:
            var = _scalar(self._cov, src)
            if self.premap is _ident or self._premap_map is not None:
                pmat, eps = self._linear_draw(src)
                unflat = _mat_sample(eps, src, var, pmat, pfill=self._premap_fill)
            else:
                means = self.premap(self._flatten(src))
                eps = self._draw(means.shape[0], means.shape[1], src)
                unflat = self._unflatten(means + torch.sqrt(var) * eps)
            self._set_cov(unflat.shape[1], src)
        else:
            means = self.premap(self._flatten(src))
            eps = self._draw(means.shape[0], means.shape[1], src)
            unflat = self._unflatten(means + eps @ self._cholesky(src).T)
        return self._out(unflat, tensor_in)

    @full_fp32()
    def log_gradient(self, source, generated):
        """Return (grad_x log g, grad_y log g); type-preserving like sample."""
        if self.cov is None and self._scalar_cov:
            raise ValueError(
                "Cannot generate log gradients without cov. Either specify "
                "cov at init, or call sample prior to log_gradient."
            )
        tensor_in, (src3, gen3) = self._inputs(source, generated)
        rank3 = (
            src3.ndim == 3
            and gen3.ndim == 3
            and src3.shape[-1] == self.n_dim
            and gen3.shape[-1] == self.n_dim
        )  # anything else takes the callable path, which validates/raises
        if (self.premap is _ident or self._premap_map is not None) and rank3:
            pmat = _map_tensor(self._premap_map, src3.device, src3.dtype)
            if self._scalar_cov:
                source_lgrad, variate_lgrad = _mat_lgrads(
                    src3, gen3, _scalar(self._cov, src3), pmat, pfill=self._premap_fill
                )
            else:
                source_lgrad, variate_lgrad = _mat_matrix_lgrads(
                    src3, gen3, self._cholesky(src3), pmat, pfill=self._premap_fill
                )
        else:
            flat_source = self._flatten(src3)
            flat_generated = self._flatten(gen3)
            if self._scalar_cov:
                src_grad, gen_grad = _scalar_lgrads(
                    flat_source, flat_generated, _scalar(self._cov, src3), self.premap
                )
            else:
                src_grad, gen_grad = _matrix_lgrads(
                    flat_source, flat_generated, self._cholesky(src3), self.premap
                )
            source_lgrad = self._unflatten(src_grad)
            variate_lgrad = self._unflatten(gen_grad)
        post = self.source_postmap(source_lgrad)
        return self._out(post, tensor_in), self._out(variate_lgrad, tensor_in)

    @full_fp32()
    def fused_augment(self, coords, forces, kbt: float):
        """Augmentation (sample + log-gradients + assembly) in one pass.

        Returns the extended (coords, forces) pair for tensor inputs with
        scalar covariance and linear (or identity) pre/post maps — the
        ``joptgauss_map`` path — or None when the piecewise path must be
        used. Draw for draw the same as sample() + log_gradient().
        """
        if not self._scalar_cov or not self._matrix_ok():
            return None
        if not isinstance(coords, torch.Tensor) or not isinstance(forces, torch.Tensor):
            return None
        _, (c, f) = self._inputs(coords, forces)
        pmat, eps = self._linear_draw(c)
        full_coords, full_forces = _fused_augment_math(
            eps, c, f, _scalar(self._cov, c), _scalar(kbt, c), pmat,
            _map_tensor(self._postmap_map, c.device, c.dtype),
            pfill=self._premap_fill, postfill=self._postmap_fill,
        )
        self._set_cov(full_coords.shape[1] - c.shape[1], c)
        return full_coords, full_forces

    @full_fp32()
    def fused_map_apply(self, coords, forces, kbt: float, coord_map, force_map):
        """Augment-then-map (the whole AugmentedTMap application) with ONE
        host sync.

        ``coord_map``/``force_map`` are the (Linear) maps over the extended
        [real | virtual] system. Returns (mapped_coords, mapped_forces), or
        None when some component cannot take this path (numpy arrays,
        matrix covariance, callable pre/post maps, non-linear maps).
        NaN semantics match applying the maps individually: handle_nans
        maps fill NaN->0 and raise on participating NaNs (both verdicts are
        fetched together after the outputs are enqueued).
        """
        from ..map import LinearMap  # local import avoids a circular dependency

        if not self._scalar_cov or not self._matrix_ok():
            return None
        if not isinstance(coords, torch.Tensor) or not isinstance(forces, torch.Tensor):
            return None
        if not isinstance(coord_map, LinearMap) or not isinstance(force_map, LinearMap):
            return None
        _, (c, f) = self._inputs(coords, forces)
        fill_c = bool(coord_map.handle_nans)
        fill_f = bool(force_map.handle_nans)
        raise_c = fill_c and not getattr(coord_map, "bypass_nan_check", False)
        raise_f = fill_f and not getattr(force_map, "bypass_nan_check", False)
        pmat, eps = self._linear_draw(c)
        mc, mf, bad_c, bad_f = _mat_fused_apply(
            eps, c, f, _scalar(self._cov, c), _scalar(kbt, c), pmat,
            _map_tensor(self._postmap_map, c.device, c.dtype),
            _map_tensor(coord_map, c.device, c.dtype),
            _map_tensor(force_map, c.device, c.dtype),
            fill_c, fill_f, pfill=self._premap_fill, postfill=self._postmap_fill,
        )
        self._set_cov(eps.shape[1] // self.n_dim, c)
        if raise_c or raise_f:
            if bool((bad_c & raise_c) | (bad_f & raise_f)):  # one host sync
                raise ValueError(
                    "NaN handling is on and multiplication tried to use a "
                    "NaN value. Check the input array and standard_matrix."
                )
        return mc, mf

    def _flatten(self, array: torch.Tensor) -> torch.Tensor:
        """(n_frames, n_sites, n_dim) -> (n_frames, n_sites*n_dim)."""
        if array.ndim != 3 or array.shape[-1] != self.n_dim:
            raise ValueError(f"Expected (*, *, {self.n_dim}) array; got {tuple(array.shape)}.")
        return array.reshape(array.shape[0], array.shape[1] * array.shape[2])

    def _unflatten(self, array: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`_flatten`."""
        if array.ndim != 2:
            raise ValueError(f"Expected rank-2 array; got {tuple(array.shape)}.")
        return array.reshape(array.shape[0], array.shape[1] // self.n_dim, self.n_dim)

    def astype(self, dtype: DTypeLike, *args, **kwargs) -> "TCondNormal":  # noqa: ARG002
        """Return an instance emitting the requested dtype, its generators
        carrying on from this instance's state."""
        new = self.__class__(
            cov=self._cov,
            premap=None if self.premap is _ident else self.premap,
            source_postmap=(
                None if self.source_postmap is _ident else self.source_postmap
            ),
            seed=self.seed,
            dtype=dtype,
            device=self.device,
        )
        for device, gen in self._gens.items():
            clone = torch.Generator(device=device)
            clone.set_state(gen.get_state())
            new._gens[device] = clone
        return new

    def to_SimpleCondNormal(self) -> SimpleCondNormal:
        """Downcast to the numpy augmenter (identity maps, scalar cov only)."""
        if not isinstance(self._cov, float):
            raise ValueError(
                "Only can convert to SimpleCondNormal for scalar-specified "
                "covariance."
            )
        if not _is_close_to_ident(self.premap):
            raise ValueError("Only can convert to SimpleCondNormal for identity premap.")
        if not _is_close_to_ident(self.source_postmap):
            raise ValueError(
                "Only can convert to SimpleCondNormal for identity source_postmap."
            )
        return SimpleCondNormal(var=self._cov, dtype=self.dtype)
