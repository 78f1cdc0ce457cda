"""The plain references against direct float64 solves on tiny systems."""

import copy

import numpy as np
import pytest
import torch

from benchmark import harness, systems
from benchmark.reference import detect, featurized, linear
from benchmark.reference.numerics import eq_lstsq, round_tf32


def _kkt(p, a, b):
    """Direct float64 solve of [[2P, A^T], [A, 0]] [x; l] = [0; b]."""
    n, m = p.shape[0], a.shape[0]
    kkt = np.block([[2 * p, a.T], [a, np.zeros((m, m))]])
    rhs = np.concatenate([np.zeros((n, b.shape[1])), b])
    return np.linalg.solve(kkt, rhs)[:n]


def test_eq_lstsq_matches_a_direct_kkt_solve():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, 12))
    p = x.T @ x + 0.1 * np.eye(12)
    a = rng.normal(size=(4, 12))
    b = rng.normal(size=(4, 2))
    got = eq_lstsq(*(torch.as_tensor(v) for v in (p, a, b)), "float64").numpy()
    np.testing.assert_allclose(got, _kkt(p, a, b), rtol=1e-10, atol=1e-12)


def test_eq_lstsq_takes_repeated_rows_once():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(40, 10))
    p = x.T @ x + np.eye(10)
    a = rng.normal(size=(3, 10))
    b = rng.normal(size=(3, 1))
    rep = lambda v: np.concatenate([v, v[:1], v[:1]])
    got = eq_lstsq(*(torch.as_tensor(v) for v in (p, rep(a), rep(b))), "float64").numpy()
    np.testing.assert_allclose(got, _kkt(p, a, b), rtol=1e-9, atol=1e-11)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-12, -3.0 - 2.0**-10], dtype=torch.float32)
    np.testing.assert_array_equal(round_tf32(x).numpy(), [1.0 + 2.0**-10, 1.0, -3.0 - 2.0**-9])


def _tiny_feat():
    cfg = copy.deepcopy(harness.load_json(harness.BENCH_DIR / "configs" / "cln025_ca.json"))
    cfg["system"].update({"n_atoms": 14, "bonded_pairs": {"start": 0, "stop": 6, "step": 2}, "cg_stride": 5})
    cfg["featurizer"]["n_basis"] = 2
    system = systems.build_system(cfg)
    coords, forces = systems.make_pool(system, 30, 7, torch.device("cpu"))
    return cfg, system, coords, forces


def test_featurized_rows_by_explicit_loops():
    cfg, system, coords, forces = _tiny_feat()
    fs = featurized.FeatSystem(system, cfg, torch.device("cpu"), torch.float64)
    site = 1
    rows = featurized.design_rows(fs, coords.double(), forces.double(), site, "float64").numpy()
    c, f = coords.double().numpy(), forces.double().numpy()
    spec, kbt = cfg["featurizer"], system.kbt
    centers = fs.centers.numpy()
    g_n, k_n = len(system.groups), spec["n_basis"]
    for t in (0, 17):
        site_pos = c[t, system.sites[site]]
        for gi, members in enumerate(system.groups):
            fg = f[t, members].sum(axis=0)
            disp = c[t, members].mean(axis=0) - site_pos
            d = np.linalg.norm(disp)
            u = disp / max(d, 1e-30)
            for k in range(k_n):
                o = (d - centers[k]) / spec["width"]
                raw = np.exp(-o * o)
                gz = max(raw, spec["clip"]) - spec["clip"]
                dphi = raw * (-2 * o / spec["width"]) if raw > spec["clip"] else 0.0
                want = fg * gz + kbt * len(members) * dphi * u
                np.testing.assert_allclose(rows[t, :, g_n + gi * k_n + k], want, rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(rows[t, :, gi], fg, rtol=1e-12)


def test_featurized_check_of_the_float64_answer_reads_zero():
    cfg, system, coords, forces = _tiny_feat()
    frames = np.array([3, 11, 20])
    sites = list(range(len(system.sites)))
    fs = featurized.FeatSystem(system, cfg, torch.device("cpu"), torch.float64)
    coefs, mapped = [], []
    for s in sites:
        x, m = featurized._low_fit(fs, coords, forces, frames, s, "float64")
        coefs.append(x[:, 0])
        mapped.append(m)
    out = featurized.check_fit(
        system, cfg, coords, forces, frames, sites, torch.stack(coefs), torch.stack(mapped, dim=1),
    )
    assert abs(out["obj_gap"]) < 1e-8
    assert out["constraint_viol"] < 1e-8
    assert out["apply_err"] < 1e-8


def test_linear_map_matches_numpy_with_the_duplication_matrix():
    cfg = copy.deepcopy(harness.load_json(harness.BENCH_DIR / "configs" / "solvated_1500.json"))
    cfg["system"].update({"n_atoms": 20, "bonded_pairs": {"start": 0, "stop": 8, "step": 2}, "cg_stride": 6})
    system = systems.build_system(cfg)
    _, forces = systems.make_pool(system, 200, 3, torch.device("cpu"))
    cmap = system.cmap_matrix()
    w = linear.solve_map(forces, cmap, linear.groups_from_pairs(20, system.pairs), 0.0, "float64").numpy()
    labels = system.group_of_atom()
    dup = np.zeros((20, labels.max() + 1))
    dup[np.arange(20), labels] = 1.0
    design = forces.double().numpy().transpose(0, 2, 1).reshape(-1, 20) @ dup
    x = _kkt(design.T @ design, cmap @ dup, np.eye(cmap.shape[0]))
    np.testing.assert_allclose(w, (dup @ x).T, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(cmap @ w.T, np.eye(cmap.shape[0]), atol=1e-12)


def test_detection_finds_the_rigid_pairs():
    cfg = harness.load_json(harness.BENCH_DIR / "configs" / "cln025_ca.json")
    system = systems.build_system(cfg)
    coords, _ = systems.make_pool(system, 500, 5, torch.device("cpu"))
    assert detect.detect(coords) == set(system.pairs)
