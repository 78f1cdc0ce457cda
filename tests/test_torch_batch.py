"""Port parity: the shared-Gram batch fits against single fits and against
the JAX package's batch."""

import json
import warnings

import numpy as np
import pytest
import torch

import aggforce_torch as pt
from aggforce_torch.qp import fusedfeat as pff
from aggforce_torch.utils.synth import synthesize_trajectory

import aggforce_tpu as jt
from aggforce_tpu.qp import fusedfeat as jff

KBT = 0.7
N_ATOMS = 24
GROUPS = {frozenset((i, i + 1)) for i in range(0, 8, 2)}
SITES = [[i] for i in range(0, N_ATOMS, 9)]


@pytest.fixture(scope="module")
def system():
    base = np.random.default_rng(0).normal(scale=0.5, size=(N_ATOMS, 3))
    coords, forces = synthesize_trajectory(base, GROUPS, 160, seed=3)
    return coords, forces


def _kw(**kw):
    return dict(
        kbt=KBT, spec=pff.GBFeatSpec(outer=2.0, n_basis=4), constraints=GROUPS,
        l2_regularization=1e3, n_constraint_frames=8, device="cpu", **kw,
    )


def _batch(coords, forces, seeds, **kw):
    return pff.fused_gb_linear_map_batch(
        pt.Trajectory(coords=coords, forces=forces),
        pt.LinearMap(SITES, n_fg_sites=N_ATOMS), seeds=seeds, **_kw(**kw),
    )


def _single(coords, forces, seed, **kw):
    return pff.fused_gb_linear_map(
        pt.Trajectory(coords=coords, forces=forces),
        pt.LinearMap(SITES, n_fg_sites=N_ATOMS),
        constraint_rng=np.random.default_rng(seed), **_kw(**kw),
    )


def test_batch_matches_single_fits(system):
    """Each seed's batch fit is its single fit: mapped forces within atol
    1e-5 (as tests/test_featlinear.py:279-306 holds the JAX batch). On the
    CPU the coefficients are bitwise equal too: the shared Gram, the
    batched assembly and the per-problem masked solve give each fit the
    numbers of its own single fit."""
    coords, forces = system
    seeds = [3, 4, 11]
    batch = _batch(coords, forces, seeds, flush_every=4)
    assert len(batch) == len(seeds)
    for seed, tmap in zip(seeds, batch):
        single = _single(coords, forces, seed)
        _, f_b = tmap.map_arrays(coords, forces)
        _, f_s = single.map_arrays(coords, forces)
        np.testing.assert_allclose(f_b, f_s, atol=1e-5)
        np.testing.assert_array_equal(
            np.stack(tmap.force_map.tags["coef_list"]),
            np.stack(single.force_map.tags["coef_list"]),
        )
        assert tmap.force_map.tags["solver_resid"] == single.force_map.tags["solver_resid"]
        assert tmap.force_map.tags["escalated"] is False


@pytest.mark.parametrize(
    "n_seeds, flush_every, warns", [(5, 4, True), (7, 4, False), (3, 8, False)],
    ids=["tail-1-of-4", "tail-3-of-4", "sole-short-window"],
)
def test_windows_and_tail_padding(system, n_seeds, flush_every, warns):
    """Windows of ``flush_every`` seeds, the tail padded to a full window
    (with a warning when more than half of it is padding), give the same
    fits as one window of every seed; a sole window shorter than
    ``flush_every`` is not padded."""
    coords, forces = system
    seeds = list(range(20, 20 + n_seeds))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        windowed = _batch(coords, forces, seeds, flush_every=flush_every)
    padded = [w for w in caught if "padded" in str(w.message)]
    assert len(padded) == int(warns)
    if warns:
        assert padded[0].filename == __file__
    whole = _batch(coords, forces, seeds, flush_every=64)
    assert len(windowed) == len(whole) == n_seeds
    for a, b in zip(windowed, whole):
        np.testing.assert_array_equal(
            np.stack(a.force_map.tags["coef_list"]), np.stack(b.force_map.tags["coef_list"])
        )


def test_window_indices_pad_by_repeating_the_last_draw():
    idx = pff._window_indices([1, 2, 3, 4, 5], 50, 6, 2)
    assert idx.shape == (3, 2, 6)
    np.testing.assert_array_equal(idx[2, 0], idx[2, 1])
    np.testing.assert_array_equal(
        idx[1, 0], np.random.default_rng(3).choice(50, size=6, replace=False)
    )
    assert pff._window_indices([7], 50, 6, 4).shape == (1, 1, 6)


def test_empty_seeds_fit_nothing(system):
    coords, forces = system
    assert _batch(coords, forces, []) == []


def _tags():
    coefs = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    return pff._LazyCoefTags(coefs, {"solver_resid": 1e-7, "escalated": False}), coefs


READS = {
    "getitem": lambda t: t["coef_list"],
    "get": lambda t: t.get("coef_list"),
    "contains": lambda t: "coef_list" in t,
    "iter": lambda t: list(t),
    "len": len,
    "keys": lambda t: list(t.keys()),
    "items": lambda t: dict(t.items()),
    "values": lambda t: list(t.values()),
    "copy": lambda t: t.copy(),
    "dict": dict,
    "unpack": lambda t: {**t},
    "repr": repr,
    "eq": lambda t: t == {},
    "ne": lambda t: t != {},
    "pop": lambda t: t.pop("coef_list"),
    "setdefault": lambda t: t.setdefault("coef_list"),
    "popitem": lambda t: t.popitem(),
}


@pytest.mark.parametrize("read", sorted(READS), ids=lambda r: r)
def test_lazy_coef_tags_materialize_on_read(read):
    """Every read accessor fetches ``coef_list`` from the device first."""
    tags, coefs = _tags()
    assert dict.__contains__(tags, "coef_list") is False
    out = READS[read](tags)
    if read in ("pop", "setdefault", "getitem", "get"):
        np.testing.assert_array_equal(np.stack(out), coefs.numpy())
    elif read == "popitem":
        assert tags._coefs_dev is None
    else:
        np.testing.assert_array_equal(np.stack(dict.__getitem__(tags, "coef_list")), coefs.numpy())


def test_lazy_coef_tags_user_value_wins():
    tags, _ = _tags()
    tags["coef_list"] = "mine"
    assert tags["coef_list"] == "mine"
    assert json.loads(json.dumps({k: v for k, v in tags.items() if k != "escalated"})) == {
        "solver_resid": 1e-7, "coef_list": "mine",
    }


def test_batch_escalation_per_fit_equals_single(system):
    """resid_tol=0 escalates every fit, each on its own recomputed
    constraint system, to the float64 oracle: each equals its single fit
    escalated the same way."""
    coords, forces = system
    seeds = [5, 6]
    batch = _batch(coords, forces, seeds, resid_tol=0.0)
    for seed, tmap in zip(seeds, batch):
        single = _single(coords, forces, seed, resid_tol=0.0)
        assert tmap.force_map.tags["escalated"] and single.force_map.tags["escalated"]
        np.testing.assert_array_equal(
            np.stack(tmap.force_map.tags["coef_list"]),
            np.stack(single.force_map.tags["coef_list"]),
        )


def test_batch_matches_jax_batch(system):
    """The port's batch against the JAX package's, seed by seed: mapped
    forces within 2e-3 * mean|f| (the fit-level bound,
    tests/test_pallas_gram.py:111-112)."""
    coords, forces = system
    seeds = [1, 2, 3]
    expect = jff.fused_gb_linear_map_batch(
        jt.trajectory.Trajectory(coords=coords, forces=forces),
        jt.LinearMap(SITES, n_fg_sites=N_ATOMS), kbt=KBT,
        spec=jff.GBFeatSpec(outer=2.0, n_basis=4), seeds=seeds, constraints=GROUPS,
        l2_regularization=1e3, n_constraint_frames=8, flush_every=2,
    )
    got = _batch(coords, forces, seeds, flush_every=2)
    for e, g in zip(expect, got):
        _, jf = e.map_arrays(coords, forces)
        _, pf = g.map_arrays(coords, forces)
        np.testing.assert_allclose(pf, np.asarray(jf), atol=2e-3 * np.abs(np.asarray(jf)).mean())


@pytest.fixture
def one_rank_mesh():
    """A world-size-1 gloo group and its CPU mesh, destroyed after the test."""
    from aggforce_torch.parallel import initialize_distributed, make_mesh

    initialize_distributed(backend="gloo")
    try:
        yield make_mesh(device="cpu")
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("entry", ["batch", "cv"])
def test_new_mesh_arguments_wait_for_item_13(system, one_rank_mesh, entry):
    """The mesh arguments of the batch fits and the featurized CV (ROADMAP
    Queue 1 item 13, now ported): on one rank the mesh path gives the
    single-device results bit for bit (the frame share is every frame and
    the all-reduces are sums of one); tests/test_torch_parallel.py runs
    two ranks."""
    coords, forces = system
    cmap = pt.LinearMap(SITES, n_fg_sites=N_ATOMS)
    if entry == "batch":
        plain = _batch(coords, forces, [1, 2, 3], flush_every=2)
        meshed = _batch(coords, forces, [1, 2, 3], flush_every=2, mesh=one_rank_mesh)
        for a, b in zip(plain, meshed):
            np.testing.assert_array_equal(
                np.stack(a.force_map.tags["coef_list"]), np.stack(b.force_map.tags["coef_list"])
            )
    else:
        from aggforce_torch.qp.cv import fused_gb_cv

        tables = [
            fused_gb_cv(
                coords, forces, cmap, GROUPS, KBT, pff.GBFeatSpec(outer=2.0), [1e3],
                n_folds=3, rng=np.random.default_rng(4), mesh=mesh, device="cpu",
            )
            for mesh in (None, one_rank_mesh)
        ]
        assert tables[0] == tables[1]
