"""Port parity: streamed (chunked) fits against the in-memory fits and the
JAX package's streamed fits."""

import numpy as np
import pytest
import torch

import aggforce_torch as pt
from aggforce_torch.io import (
    TrajectoryStream,
    fused_gb_linear_map_streamed,
    qp_linear_map_streamed,
)
from aggforce_torch.io.stream import streamed_linear_gram, streamed_site_grams
from aggforce_torch.qp.fusedfeat import GBFeatSpec, fused_gb_linear_map, group_factorization
from aggforce_torch.qp.qplinear import constraint_labels
from aggforce_torch.utils.synth import synthesize_trajectory

import aggforce_tpu as jt
from aggforce_tpu import io as jio

N_ATOMS = 24
GROUPS = [frozenset((i, i + 1)) for i in range(0, 8, 2)]
SITES = [[i] for i in range(0, N_ATOMS, 9)]
KBT = 0.6955215
SPEC = GBFeatSpec(outer=2.0, n_basis=4)


@pytest.fixture(scope="module")
def system():
    base = np.random.default_rng(0).normal(scale=0.5, size=(N_ATOMS, 3))
    coords, forces = synthesize_trajectory(base, GROUPS, 700, seed=3)
    return coords.astype(np.float32), forces.astype(np.float32)


def _cmap():
    return pt.LinearMap(SITES, n_fg_sites=N_ATOMS)


def test_stream_chunks_cover_all_frames(system):
    """Chunks of chunk_size frames and a ragged, unpadded last chunk."""
    coords, forces = system
    s = TrajectoryStream.from_arrays(coords, forces, chunk_size=256)
    sizes = []
    for cc, fc, n_valid in s.chunks():
        assert cc.shape[0] == fc.shape[0] == n_valid
        sizes.append(n_valid)
    assert sizes == [256, 256, 188]
    assert len(s) == s.n_frames == 700 and s.n_sites == N_ATOMS
    np.testing.assert_array_equal(
        np.concatenate([c for c, _, _ in s.chunks()]), coords
    )
    with pytest.raises(ValueError, match="contiguous"):
        list(s.chunks(slice(0, 700, 2)))


def test_streamed_linear_matches_in_memory_and_jax(system):
    coords, forces = system
    stream = TrajectoryStream.from_arrays(coords, forces, chunk_size=256)
    streamed = qp_linear_map_streamed(stream, _cmap(), set(GROUPS), device="cpu")
    in_memory = pt.qp_linear_map(
        pt.Trajectory(coords=coords, forces=forces), _cmap(), constraints=set(GROUPS),
        device="cpu",
    )
    jax = jio.qp_linear_map_streamed(
        jio.TrajectoryStream.from_arrays(coords, forces, chunk_size=256),
        jt.LinearMap(SITES, n_fg_sites=N_ATOMS), constraints=set(GROUPS),
    )
    got = streamed.force_map.standard_matrix
    assert isinstance(streamed.force_map, pt.TLinearMap)
    np.testing.assert_allclose(got, in_memory.force_map.standard_matrix, atol=5e-5)
    np.testing.assert_allclose(got, np.asarray(jax.force_map.standard_matrix), atol=5e-5)


def test_streamed_linear_from_npy(tmp_path, system):
    """Memory-mapped .npy source: only chunks are read, the same map."""
    coords, forces = system
    cp, fp = tmp_path / "c.npy", tmp_path / "f.npy"
    np.save(cp, coords)
    np.save(fp, forces)
    stream = TrajectoryStream.from_npy(str(cp), str(fp), chunk_size=192)
    assert isinstance(stream.coords, np.memmap)
    streamed = qp_linear_map_streamed(stream, _cmap(), set(GROUPS), device="cpu")
    in_memory = pt.qp_linear_map(
        pt.Trajectory(coords=coords, forces=forces), _cmap(), constraints=set(GROUPS),
        device="cpu",
    )
    np.testing.assert_allclose(
        streamed.force_map.standard_matrix, in_memory.force_map.standard_matrix,
        atol=5e-5,
    )


def test_streamed_linear_escalation_path():
    """resid_tol=-1 fails every float32 solve: the Gram is streamed again in
    float64 and solved on the host, as in the JAX package."""
    rng = np.random.default_rng(4)
    forces = rng.normal(size=(64, 6, 3)).astype(np.float32)
    coords = rng.normal(size=(64, 6, 3)).astype(np.float32)
    cmap = pt.LinearMap([[0], [3]], n_fg_sites=6)
    stream = TrajectoryStream.from_arrays(coords, forces, chunk_size=16)
    tmap = qp_linear_map_streamed(stream, cmap, set(), resid_tol=-1.0, device="cpu")
    fm = np.asarray(tmap.force_map.standard_matrix)
    assert np.all(np.isfinite(fm))
    np.testing.assert_allclose(cmap.standard_matrix @ fm.T, np.eye(2), atol=1e-6)
    jax = jio.qp_linear_map_streamed(
        jio.TrajectoryStream.from_arrays(coords, forces, chunk_size=16),
        jt.LinearMap([[0], [3]], n_fg_sites=6), set(), resid_tol=-1.0,
    )
    np.testing.assert_allclose(fm, np.asarray(jax.force_map.standard_matrix), atol=1e-6)


def test_streamed_featurized_matches_in_memory(system):
    """Ragged chunks (700 = 2 x 256 + 188), the in-memory fit's constraint
    draw: mapped forces within 1e-3 RMS of the in-memory fit's, and the
    solver's residual below 1e-4."""
    coords, forces = system
    kw = dict(
        kbt=KBT, spec=SPEC, constraints=set(GROUPS), l2_regularization=1e3,
        device="cpu",
    )
    stream = TrajectoryStream.from_arrays(coords, forces, chunk_size=256)
    streamed = fused_gb_linear_map_streamed(
        stream, _cmap(), constraint_rng=np.random.default_rng(3), **kw
    )
    in_memory = fused_gb_linear_map(
        pt.Trajectory(coords=coords, forces=forces), _cmap(),
        constraint_rng=np.random.default_rng(3), **kw,
    )
    _, f_s = streamed.map_arrays(coords[:64], forces[:64])
    _, f_m = in_memory.map_arrays(coords[:64], forces[:64])
    rms = np.sqrt(np.mean((f_s - f_m) ** 2))
    assert rms < 1e-3 * np.sqrt(np.mean(f_m**2))
    assert streamed.force_map.tags["solver_resid"] < 1e-4


def test_streamed_featurized_matches_jax_streamed(system):
    coords, forces = system
    stream = TrajectoryStream.from_arrays(coords, forces, chunk_size=256)
    port = fused_gb_linear_map_streamed(
        stream, _cmap(), kbt=KBT, spec=SPEC, constraints=set(GROUPS),
        l2_regularization=1e3, constraint_rng=np.random.default_rng(5), device="cpu",
    )
    from aggforce_tpu.qp.fusedfeat import GBFeatSpec as JSpec

    jax = jio.fused_gb_linear_map_streamed(
        jio.TrajectoryStream.from_arrays(coords, forces, chunk_size=256),
        jt.LinearMap(SITES, n_fg_sites=N_ATOMS), kbt=KBT,
        spec=JSpec(outer=2.0, n_basis=4), constraints=set(GROUPS),
        l2_regularization=1e3, constraint_rng=np.random.default_rng(5),
    )
    _, jf = jax.map_arrays(coords[:64], forces[:64])
    _, pf = port.map_arrays(coords[:64], forces[:64])
    np.testing.assert_allclose(pf, np.asarray(jf), atol=2e-3 * np.abs(jf).mean())


def test_frame_slice_partitions_sum(system):
    """The Grams of frame slices that partition the range add up to the
    whole range's Gram, for both streamed updates."""
    coords, forces = system
    stream = TrajectoryStream.from_arrays(coords, forces, chunk_size=128)
    halves = [slice(0, 350), slice(350, 700)]
    assert sum(n for sl in halves for _, _, n in stream.chunks(sl)) == 700

    labels_np, r = constraint_labels(N_ATOMS, set(GROUPS))
    labels = torch.as_tensor(labels_np, dtype=torch.int64)
    whole = streamed_linear_gram(stream, labels, r)
    parts = sum(streamed_linear_gram(stream, labels, r, sl) for sl in halves)
    torch.testing.assert_close(parts, whole, rtol=1e-5, atol=1e-5 * float(whole.abs().max()))

    geom = group_factorization(_cmap(), SPEC, set(GROUPS))
    consts = tuple(
        torch.as_tensor(np.asarray(x), dtype=torch.float32)
        for x in (
            _cmap().standard_matrix, geom["group_mean"], geom["onehot"],
            geom["counts"], geom["centers"],
        )
    )
    whole = streamed_site_grams(stream, consts, KBT, SPEC)
    parts = sum(streamed_site_grams(stream, consts, KBT, SPEC, sl) for sl in halves)
    torch.testing.assert_close(parts, whole, rtol=1e-5, atol=1e-5 * float(whole.abs().max()))


def test_streamed_fit_of_a_slice_is_the_fit_of_its_frames(system):
    coords, forces = system
    stream = TrajectoryStream.from_arrays(coords, forces, chunk_size=100)
    part = qp_linear_map_streamed(
        stream, _cmap(), set(GROUPS), frame_slice=slice(200, 650), device="cpu"
    )
    direct = pt.qp_linear_map(
        pt.Trajectory(coords=coords[200:650], forces=forces[200:650]), _cmap(),
        constraints=set(GROUPS), device="cpu",
    )
    np.testing.assert_allclose(
        part.force_map.standard_matrix, direct.force_map.standard_matrix, atol=5e-5
    )


def test_streamed_mesh_raises(system):
    """Both streamed fits check ``mesh`` (not a mesh: TypeError) and, on one
    rank, give the single-process streamed maps bit for bit;
    tests/test_torch_distributed.py runs two ranks with frame slices."""
    from aggforce_torch.parallel import initialize_distributed, make_mesh

    coords, forces = system
    stream = TrajectoryStream.from_arrays(coords, forces, chunk_size=256)
    with pytest.raises(TypeError, match="FrameMesh"):
        qp_linear_map_streamed(stream, _cmap(), mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="FrameMesh"):
        fused_gb_linear_map_streamed(
            stream, _cmap(), kbt=KBT, spec=SPEC, mesh=object(), device="cpu"
        )
    initialize_distributed(backend="gloo")
    try:
        mesh = make_mesh(device="cpu")
        lin = [
            qp_linear_map_streamed(stream, _cmap(), set(GROUPS), mesh=m, device="cpu")
            for m in (None, mesh)
        ]
        feat = [
            fused_gb_linear_map_streamed(
                stream, _cmap(), kbt=KBT, spec=SPEC, constraints=set(GROUPS),
                constraint_rng=np.random.default_rng(3), mesh=m, device="cpu",
            )
            for m in (None, mesh)
        ]
    finally:
        torch.distributed.destroy_process_group()
    np.testing.assert_array_equal(lin[0].force_map.standard_matrix, lin[1].force_map.standard_matrix)
    np.testing.assert_array_equal(
        np.stack(feat[0].force_map.tags["coef_list"]), np.stack(feat[1].force_map.tags["coef_list"])
    )


def test_streamed_grams_take_any_chunk_source(system):
    """The streamed Grams read a stream only through ``chunks(frame_slice)``,
    ``chunk_size`` and ``n_sites``: a wrapper with just those gives the
    stream's own Grams (with and without a frame slice)."""
    coords, forces = system
    stream = TrajectoryStream.from_arrays(coords, forces, chunk_size=128)

    class Wrapped:
        chunk_size, n_sites = stream.chunk_size, stream.n_sites

        def chunks(self, frame_slice=None):
            return stream.chunks(frame_slice)

    labels_np, r = constraint_labels(N_ATOMS, set(GROUPS))
    labels = torch.as_tensor(labels_np, dtype=torch.int64)
    geom = group_factorization(_cmap(), SPEC, set(GROUPS))
    consts = tuple(
        torch.as_tensor(np.asarray(x), dtype=torch.float32)
        for x in (
            _cmap().standard_matrix, geom["group_mean"], geom["onehot"],
            geom["counts"], geom["centers"],
        )
    )
    for sl in (None, slice(100, 500)):
        torch.testing.assert_close(
            streamed_linear_gram(Wrapped(), labels, r, sl),
            streamed_linear_gram(stream, labels, r, sl), rtol=0, atol=0,
        )
        torch.testing.assert_close(
            streamed_site_grams(Wrapped(), consts, KBT, SPEC, sl),
            streamed_site_grams(stream, consts, KBT, SPEC, sl), rtol=0, atol=0,
        )


def test_stream_validates_shapes(system):
    coords, forces = system
    with pytest.raises(ValueError, match="same shape"):
        TrajectoryStream(coords, forces[:10])
    with pytest.raises(ValueError, match="n_frames, n_sites, n_dim"):
        TrajectoryStream(coords[0], forces[0])
