"""Port parity: the Gaussian noised-map builders against the JAX package's.

On one small synthetic system (40 atoms, 6 rigid pairs, 4 cg sites, 400
frames), made from a seed with numpy. The fits are deterministic given the
augmented arrays, so where the port is fed JAX's draw (or JAX's augmented
arrays) it must give JAX's maps within the linear fit's tolerance
(tests/test_torch_qplinear.py); the port's fused and piecewise staged paths
must agree within the JAX package's own tolerances
(tests/test_gaussmap.py:245-258); and two different optimized maps must
agree on MSCG projections (tests/test_gaussmap.py:168-219).
"""

import re
import warnings

import jax.numpy as jnp
import jax.random as jrandom
import numpy as np
import pytest
import torch

import aggforce_torch as pt
from aggforce_torch import mapval as pmv
from aggforce_torch import models as pmodels
from aggforce_torch.convert import gauss_map_from_numpy, staged_gauss_map_from_numpy
from aggforce_torch.map import lmap_augvariables
from aggforce_torch.qp import gauss as pgauss
from aggforce_torch.qp import gauss_fused as pfused
from aggforce_torch.qp.qplinear import constraint_labels, fit_routes, qp_linear_map
from aggforce_torch.trajectory import AugmentedTrajectory, CoordsTrajectory, TCondNormal
from aggforce_torch.trajectory import gaussian as paug
from aggforce_torch.utils.synth import synthesize_trajectory

import aggforce_tpu as jt
from aggforce_tpu import models as jmodels
from aggforce_tpu.map import JLinearMap
from aggforce_tpu.qp import jgauss
from aggforce_tpu.qp import jgauss_fused as jfused
from aggforce_tpu.trajectory import JCondNormal

VAR = 0.002
KBT = 0.6955215
N_ATOMS = 40
N_FRAMES = 400
GROUPS = {frozenset((i, i + 1)) for i in range(0, 12, 2)}
SITES = [[i] for i in range(0, N_ATOMS, 10)]
S = len(SITES)
# the linear fit's parity with JAX (tests/test_torch_qplinear.py): largest
# coefficient difference over the largest coefficient; mapped forces,
# relative RMS
FIT_TOL = 1e-4
MAPPED_REL_RMS = 1e-5
# the fused staged path against the piecewise one (tests/test_gaussmap.py:
# 245-258): premap 2e-4 and second stage 2e-3 of the largest entry, mapped
# coordinates 1e-5, mapped forces 2e-3 of the largest entry
PRE_TOL, POST_TOL, COORD_TOL = 2e-4, 2e-3, 1e-5


@pytest.fixture(scope="module")
def system():
    base = np.random.default_rng(0).normal(scale=0.5, size=(N_ATOMS, 3))
    coords, forces = synthesize_trajectory(base, GROUPS, N_FRAMES, seed=3)
    return coords, forces


def _cmaps():
    return pt.LinearMap(SITES, n_fg_sites=N_ATOMS), jt.LinearMap(SITES, n_fg_sites=N_ATOMS)


def _jax_eps(seed, n_frames, width):
    """The draw of a fresh JCondNormal(seed)'s first augmentation."""
    rkey, _ = jrandom.split(jrandom.PRNGKey(seed))
    _, sub = jrandom.split(rkey)
    return np.asarray(jrandom.normal(sub, (n_frames, width)))


@pytest.fixture()
def jax_draw(monkeypatch):
    """Make every port draw return the given array (JAX's draw)."""
    fed = {}

    def draw(gen, shape, device, dtype):  # noqa: ARG001
        assert tuple(shape) == fed["eps"].shape
        return torch.tensor(fed["eps"], device=device, dtype=dtype)

    monkeypatch.setattr(paug, "_standard_normal", draw)
    return fed


@pytest.fixture()
def recorded_draws(monkeypatch):
    """Record every port draw (the generator is untouched)."""
    draws = []
    real = paug._standard_normal

    def draw(*args):
        out = real(*args)
        draws.append(out.clone())
        return out

    monkeypatch.setattr(paug, "_standard_normal", draw)
    return draws


def _fit_close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.abs(got - ref).max() <= FIT_TOL * np.abs(ref).max()


def _rel_rms(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref**2)))


def _scaled_close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, atol=tol * np.abs(ref).max(), rtol=0)


def test_joptgauss_fit_equals_jax(system, jax_draw):
    """JAX's augmented trajectory fitted by the port (through
    ``override_first_augment`` and ``lmap_augvariables``), and the port's
    ``joptgauss_map`` fed JAX's draw, both give JAX's force map."""
    coords, forces = system
    pcmap, jcmap = _cmaps()
    seed = 5
    jmap = jgauss.joptgauss_map(
        jt.Trajectory(coords=coords, forces=forces), jcmap, var=VAR, kbt=KBT,
        constraints=GROUPS, seed=seed,
    )
    jaug = jt.trajectory.AugmentedTrajectory.from_trajectory(
        t=jt.Trajectory(coords=coords, forces=forces), kbt=KBT,
        augmenter=JCondNormal(
            cov=VAR, premap=JLinearMap.from_linearmap(jcmap, bypass_nan_check=True).flat_call,
            seed=seed,
        ),
    )
    ref = np.asarray(jmap.tmap.force_map.standard_matrix)

    aug = AugmentedTrajectory(
        coords=coords, forces=forces, kbt=KBT,
        augmenter=TCondNormal(cov=VAR, seed=seed, device="cpu"),
        override_first_augment=(jaug.coords, jaug.forces),
    )
    refit = qp_linear_map(aug, lmap_augvariables(aug), constraints=GROUPS, device="cpu")
    _fit_close(refit.force_map.standard_matrix, ref)

    jax_draw["eps"] = _jax_eps(seed, N_FRAMES, S * 3)
    pmap = pgauss.joptgauss_map(
        pt.Trajectory(coords=coords, forces=forces), pcmap, var=VAR, kbt=KBT,
        constraints=GROUPS, seed=seed, device="cpu",
    )
    _fit_close(pmap.tmap.force_map.standard_matrix, ref)
    _, mj = jmap.tmap.map_arrays(jaug.coords, jaug.forces)
    _, mp = pmap.tmap.map_arrays(jaug.coords, jaug.forces)
    assert _rel_rms(mp, mj) <= MAPPED_REL_RMS


def test_staged_premap_fit_equals_jax(system):
    """The staged premap fit is deterministic: the port's equals JAX's."""
    coords, forces = system
    pcmap, jcmap = _cmaps()
    kw = dict(var=VAR, kbt=KBT, constraints=GROUPS, seed=3)
    jmap = jgauss.stagedjoptgauss_map(jt.Trajectory(coords=coords, forces=forces), jcmap, **kw)
    pmap = pgauss.stagedjoptgauss_map(
        pt.Trajectory(coords=coords, forces=forces), pcmap, device="cpu", **kw
    )
    _fit_close(pmap[1].force_map.standard_matrix, jmap[1].force_map.standard_matrix)
    _, mj = jmap[1].map_arrays(coords, forces)
    _, mp = pmap[1].map_arrays(coords, forces)
    assert _rel_rms(mp, mj) <= MAPPED_REL_RMS


@pytest.mark.parametrize("zero_stage2", [False, True], ids=["opt", "force"])
def test_fused_program_equals_jax(system, zero_stage2):
    """``_staged_gauss_program`` fed JAX's draw against JAX's with its key:
    both force maps, and the noise contribution."""
    coords, forces = system
    pcmap, _ = _cmaps()
    seed = 11
    labels, r = constraint_labels(N_ATOMS, GROUPS)
    cmat = pcmap.standard_matrix.astype(np.float32)
    rkey, _ = jrandom.split(jrandom.PRNGKey(seed))
    _, subkey = jrandom.split(rkey)
    jout = jfused._staged_gauss_program(
        jnp.asarray(coords), jnp.asarray(forces), subkey, jnp.asarray(cmat),
        jnp.asarray(labels), None, jnp.float32(VAR), jnp.float32(KBT),
        jnp.float32(0.0), jnp.float32(0.0), r=r, n_aug=S,
        zero_stage2=zero_stage2, use_input_forcemap=False,
    )
    f32 = torch.float32
    pout = pfused._staged_gauss_program(
        torch.as_tensor(coords), torch.as_tensor(forces),
        torch.tensor(_jax_eps(seed, N_FRAMES, S * 3)), torch.as_tensor(cmat),
        torch.as_tensor(labels, dtype=torch.int64), r, None,
        torch.tensor(VAR, dtype=f32), torch.tensor(KBT, dtype=f32), 0.0, 0.0, zero_stage2,
    )
    fmap1, resid1, fmap2, resid2, remaining = (np.asarray(x) for x in jout)
    _fit_close(pout[0].numpy(), fmap1)
    _fit_close(pout[2].numpy(), fmap2)
    assert float(pout[1]) <= 1e-4 and float(pout[3]) <= 1e-4
    if zero_stage2:
        # the noise cancels: both leave float32 rounding only
        assert float(pout[4]) <= 1e-6 and float(remaining) <= 1e-6
    else:
        assert abs(float(pout[4]) - float(remaining)) <= FIT_TOL * float(remaining)


@pytest.mark.parametrize("builder", ["stagedjoptgauss_map", "stagedjforcegauss_map"])
def test_fused_matches_piecewise(system, monkeypatch, recorded_draws, builder):
    """The port's one-sync staged fits against its piecewise fits, at the
    JAX package's tolerances: same premap, same draw, same second stage,
    same mapped data under the same seed."""
    coords, forces = system
    pcmap, _ = _cmaps()
    build = getattr(pgauss, builder)
    traj = pt.Trajectory(coords=torch.as_tensor(coords), forces=torch.as_tensor(forces))
    kw = dict(var=VAR, kbt=KBT, constraints=GROUPS, seed=12)
    fit_routes.clear()
    t_fused = build(traj, pcmap, **kw)
    assert fit_routes["staged_fused"] == 1 and "staged_fused_missed" not in fit_routes
    monkeypatch.setenv("AGGFORCE_STAGED_FUSED", "0")
    t_piece = build(traj, pcmap, **kw)
    assert fit_routes["staged_fused"] == 1
    fused_draw, piece_draw = recorded_draws
    torch.testing.assert_close(fused_draw, piece_draw, rtol=0, atol=0)

    _scaled_close(t_fused[1].force_map.standard_matrix, t_piece[1].force_map.standard_matrix, PRE_TOL)
    _scaled_close(
        t_fused[0].tmap.force_map.standard_matrix, t_piece[0].tmap.force_map.standard_matrix,
        POST_TOL,
    )
    cf, ff = t_fused.map_arrays(traj.coords[:64], traj.forces[:64])
    cp, fp = t_piece.map_arrays(traj.coords[:64], traj.forces[:64])
    assert isinstance(cf, torch.Tensor)
    np.testing.assert_allclose(cf.numpy(), cp.numpy(), atol=COORD_TOL, rtol=0)
    _scaled_close(ff.numpy(), fp.numpy(), POST_TOL)


def test_staged_float64_tensors_fit_piecewise_in_float64(system):
    coords, forces = system
    pcmap, _ = _cmaps()
    traj = pt.Trajectory(
        coords=torch.as_tensor(coords, dtype=torch.float64),
        forces=torch.as_tensor(forces, dtype=torch.float64),
    )
    fit_routes.clear()
    tmap = pgauss.stagedjoptgauss_map(traj, pcmap, var=VAR, kbt=KBT, constraints=GROUPS, seed=2)
    assert "staged_fused" not in fit_routes
    assert tmap[1].force_map.standard_matrix.dtype == np.float64
    assert tmap[0].tmap.force_map.standard_matrix.dtype == np.float64
    assert tmap(traj).forces.dtype == torch.float64


def test_slice_map_coords_only(system):
    """Coordinates in, noise-derived forces out: -kbt (y - Mx)/var; input
    forces are discarded with a warning."""
    coords, _ = system
    pcmap, _ = _cmaps()
    for arrays in (coords[:150], torch.as_tensor(coords[:150])):
        tmap = pgauss.stagedjslicegauss_map(
            CoordsTrajectory(coords=arrays), pcmap, var=VAR, kbt=KBT, seed=8,
            warn_input_forces=False, device="cpu",
        )
        assert len(tmap.submaps) == 3
        _, null_forces = tmap[2].map_arrays(arrays)
        assert bool(np.isnan(np.asarray(null_forces)).all())
        mapped_c, mapped_f = tmap.map_arrays(arrays, None)
        assert isinstance(mapped_f, type(arrays)) and mapped_c.shape == (150, S, 3)
        mapped_c, mapped_f = np.asarray(mapped_c), np.asarray(mapped_f)
        resid = mapped_c - pcmap(coords[:150])
        np.testing.assert_allclose(mapped_f, -KBT * resid / VAR, atol=1e-3)
    with pytest.warns(UserWarning, match="Discarding forces"):
        pgauss.stagedjslicegauss_map(
            pt.Trajectory(coords=coords[:50], forces=np.zeros_like(coords[:50])),
            pcmap, var=VAR, kbt=KBT, seed=8, device="cpu",
        )


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "piecewise"])
def test_force_variant_remaining(system, monkeypatch, fused):
    """The force variant cancels the noise contribution below its 1e-6
    tolerance, warns (with the remaining contribution) only above it, and
    maps to the premap's forces."""
    coords, forces = system
    pcmap, _ = _cmaps()
    if not fused:
        monkeypatch.setenv("AGGFORCE_STAGED_FUSED", "0")
    traj = pt.Trajectory(coords=torch.as_tensor(coords), forces=torch.as_tensor(forces))
    kw = dict(var=VAR, kbt=KBT, constraints=GROUPS, seed=4)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tmap = pgauss.stagedjforcegauss_map(traj, pcmap, **kw)
    with pytest.warns(UserWarning, match="Remaining") as caught:
        pgauss.stagedjforcegauss_map(traj, pcmap, contribution_tolerance=-1.0, **kw)
    remaining = float(re.search(r"contribution: (\S+)\.$", str(caught[0].message)).group(1))
    assert 0.0 <= remaining <= 1e-6
    pre_forces = tmap[1](traj).forces
    err = float((tmap(traj).forces - pre_forces).abs().max())
    assert err < 2e-2 * float(pre_forces.std())


def test_project_forces_with_joptgauss(system):
    coords, forces = system
    pcmap, _ = _cmaps()
    res = pt.project_forces(
        coords, forces, pcmap, method=pt.joptgauss_map, var=VAR, kbt=KBT, seed=3,
        device="cpu",
    )
    assert res["constraints"] == GROUPS
    assert res["mapped_forces"].shape == (N_FRAMES, S, 3)
    assert np.isfinite(res["mapped_forces"]).all()
    noise = res["mapped_coords"] - pcmap(coords)
    assert abs(noise.mean()) < 5 * np.sqrt(VAR / noise.size)
    # the map keeps noising fresh inputs: two applications differ
    again = res["tmap"].map_arrays(coords, forces)[0]
    assert not np.allclose(again, res["mapped_coords"])


def test_gauss_vs_staged_mscg_consistency(system):
    """The two optimized maps agree on MSCG projections onto random CG
    force-fields (the reference's correctness-without-ground-truth check):
    correlation > 0.9, relative difference of the means < 0.1."""
    coords, forces = system
    pcmap, _ = _cmaps()
    train = pt.Trajectory(coords=coords[:300], forces=forces[:300])
    kw = dict(var=VAR, kbt=KBT, constraints=GROUPS, device="cpu")
    t_a = pgauss.joptgauss_map(train, pcmap, seed=0, **kw)
    t_b = pgauss.stagedjoptgauss_map(train, pcmap, seed=1, **kw)

    def projections(tmap):
        mapped = [tmap.map_arrays(coords[300:], forces[300:]) for _ in range(30)]
        return np.array(pmv.random_force_proj(
            coords=np.concatenate([m[0] for m in mapped]),
            forces=np.concatenate([m[1] for m in mapped]),
            n_samples=60, randg=np.random.default_rng(1234), average=False,
            inner=0.2, outer=1.2, width=0.5, device="cpu",
        ))

    pa, pb = projections(t_a), projections(t_b)
    corr = np.corrcoef(pa, pb)[0, 1]
    rel_diff = abs(pa.mean() - pb.mean()) / (abs(pa.mean()) + 1e-12)
    assert corr > 0.9, (corr, rel_diff)
    assert rel_diff < 0.1, (corr, rel_diff)


def test_registry_names_the_port_builders():
    assert pmodels.available_families() == jmodels.available_families()
    for name in pmodels.available_families():
        builder = pmodels.get_map_builder(name)
        assert builder.__module__.startswith("aggforce_torch.")
        assert builder.__name__ == jmodels.get_map_builder(name).__name__
    assert pmodels.get_map_builder("gauss") is pt.joptgauss_map
    with pytest.raises(ValueError, match="Unknown map family"):
        pmodels.get_map_builder("nope")


@pytest.mark.parametrize(
    "builder", ["joptgauss_map", "stagedjoptgauss_map", "stagedjforcegauss_map"]
)
def test_mesh_raises(system, builder):
    """Each builder that takes a mesh checks it (not a mesh: TypeError) and,
    on one rank, gives the single-device maps bit for bit (the piecewise
    path here: numpy data); tests/test_torch_parallel.py runs two ranks."""
    from aggforce_torch.parallel import initialize_distributed, make_mesh

    coords, forces = system
    pcmap, _ = _cmaps()
    traj = pt.Trajectory(coords=coords, forces=forces)
    with pytest.raises(TypeError, match="FrameMesh"):
        getattr(pgauss, builder)(traj, pcmap, var=VAR, kbt=KBT, mesh=object(), device="cpu")
    initialize_distributed(backend="gloo")
    try:
        maps = [
            getattr(pgauss, builder)(
                traj, pcmap, var=VAR, kbt=KBT, constraints=GROUPS, seed=21, device="cpu",
                **({} if mesh is None else {"mesh": mesh}),
            )
            for mesh in (None, make_mesh(device="cpu"))
        ]
    finally:
        torch.distributed.destroy_process_group()
    if builder == "joptgauss_map":
        pairs = [(m.tmap.force_map,) for m in maps]
    else:
        pairs = [(m[1].force_map, m[0].tmap.force_map) for m in maps]
    for a, b in zip(*pairs):
        np.testing.assert_array_equal(a.standard_matrix, b.standard_matrix)


def test_converted_jax_maps_apply_with_jax_draw(system, jax_draw):
    """A Gaussian map fitted by JAX, carried over as plain arrays and
    applied by the port to JAX's draw, gives JAX's mapped data; so does a
    staged map."""
    coords, forces = system
    _, jcmap = _cmaps()
    jtraj = jt.Trajectory(coords=jnp.asarray(coords), forces=jnp.asarray(forces))
    ptraj = pt.Trajectory(coords=torch.as_tensor(coords), forces=torch.as_tensor(forces))

    jmap = jgauss.joptgauss_map(jtraj, jcmap, var=VAR, kbt=KBT, constraints=GROUPS, seed=6)
    pmap = gauss_map_from_numpy(
        coord_mat=jmap.tmap.coord_map.standard_matrix,
        force_mat=jmap.tmap.force_map.standard_matrix,
        cov=VAR, kbt=KBT, premap_mat=jcmap.standard_matrix, device="cpu",
    )
    _, sub = jrandom.split(jmap.augmenter._rkey)  # the key of JAX's next draw
    jax_draw["eps"] = np.asarray(jrandom.normal(sub, (N_FRAMES, S * 3)))
    jout, pout = jmap(jtraj), pmap(ptraj)
    np.testing.assert_allclose(pout.coords.numpy(), np.asarray(jout.coords), atol=1e-6, rtol=0)
    _scaled_close(pout.forces.numpy(), jout.forces, 1e-6)

    jstaged = jgauss.stagedjoptgauss_map(
        jtraj, jcmap, var=VAR, kbt=KBT, constraints=GROUPS, seed=9
    )
    pre, post = jstaged[1], jstaged[0]
    pstaged = staged_gauss_map_from_numpy(
        pre_coord_mat=pre.coord_map.standard_matrix,
        pre_force_mat=pre.force_map.standard_matrix,
        post_coord_mat=post.tmap.coord_map.standard_matrix,
        post_force_mat=post.tmap.force_map.standard_matrix,
        cov=VAR, kbt=KBT, device="cpu",
    )
    _, sub = jrandom.split(post.augmenter._rkey)
    jax_draw["eps"] = np.asarray(jrandom.normal(sub, (N_FRAMES, S * 3)))
    jout, pout = jstaged(jtraj), pstaged(ptraj)
    np.testing.assert_allclose(pout.coords.numpy(), np.asarray(jout.coords), atol=1e-6, rtol=0)
    _scaled_close(pout.forces.numpy(), jout.forces, 1e-6)
