"""The port's example scripts on the CPU at a tiny size.

Smoke: each ``--demo`` runs two gloo processes and must end with its OK
line; each twin of a JAX example (``examples/torch_*.py``) runs as a fresh
process and must print the JAX example's marker lines
(tests/test_examples.py). Parity: the twins' results, through their
``main(argv)``, against the JAX API called with the JAX example's own
arguments on the same numpy fixture; on a tiny PDB the twins' ``--pdb``
path against the JAX examples' ``main``.
"""

import contextlib
import csv
import importlib.util
import io
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import jax.random as jrandom
import numpy as np
import pytest
import torch

from aggforce_torch.trajectory import gaussian as paug
from aggforce_torch.utils.synth import standalone_fixture, synthesize_dimer_fixture

import aggforce_tpu as jt
from aggforce_tpu.agg import project_forces_grid_cv as jax_grid_cv
from aggforce_tpu.constraints import guess_pairwise_constraints as jax_constraints
from aggforce_tpu.qp.fusedfeat import GBFeatSpec as JaxSpec
from aggforce_tpu.qp.fusedfeat import fused_gb_linear_map_batch as jax_batch
from aggforce_tpu.utils.pdblite import ca_map_from_pdb, n_atoms
from aggforce_tpu.utils.serialize import load_tmap as jax_load_tmap
from aggforce_tpu.utils.synth import synthesize_protein_fixture as jax_protein_fixture

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"
KBT = 0.6955215


def _run(script: str, *args: str) -> subprocess.CompletedProcess:
    # one thread per demo process: the suite runs beside other test workers
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(key, None)
    return subprocess.run(
        [sys.executable, str(EXAMPLES / script), *args],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(REPO),
    )


def _load(name: str):
    """An example script as a module (by path: examples/ is no package)."""
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture()
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize(
    "script, args, ok",
    [
        ("torch_sharded.py", ("--demo", "--frames", "300", "--atoms", "30"), "sharded demo OK"),
        ("torch_multihost_sweep.py", ("--demo",), "multihost sweep demo OK"),
    ],
    ids=["sharded", "multihost_sweep"],
)
def test_example_demo(script, args, ok):
    proc = _run(script, *args)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert ok in proc.stdout


# the twins' default system at a tiny size, and the JAX examples' markers
@pytest.mark.parametrize(
    "script, args, markers",
    [
        ("torch_gauss.py", ("--frames", "120"),
         ("in-sample force residuals", "staged save/load OK")),
        ("torch_production_fit.py", ("--frames", "150"),
         ("production fit demo OK", "serialized map round-trips")),
        ("torch_bootstrap.py", ("--n-maps", "4", "--window", "2"),
         ("coefficient spread", "mean squared mapped force")),
        ("torch_cv_feat.py", ("--frames", "90", "--folds", "2", "--quick"),
         ("best point", "static-map control", "full-data refit residual")),
    ],
    ids=["gauss", "production_fit", "bootstrap", "cv_feat"],
)
def test_twin_smoke(script, args, markers):
    proc = _run(script, "--device", "cpu", *args)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    first = proc.stdout.splitlines()[0]
    if script == "torch_bootstrap.py":
        assert first.startswith("data: synthesize_dimer_fixture()")
    else:
        assert first == "system: standalone (bench.py:290-307)"
    for marker in markers:
        assert marker in proc.stdout


def test_production_mesh_demo():
    """Two gloo ranks: each streams its half of the frames, and the merged
    fit maps like the in-memory fit."""
    proc = _run("torch_production_fit.py", "--demo", "--frames", "120")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "production fit demo OK" in proc.stdout
    for rank, frames in ((0, "[0, 60)"), (1, "[60, 120)")):
        assert f"rank {rank}: frames {frames}, mesh-streamed fit (2 ranks)" in proc.stdout


@pytest.mark.parametrize(
    "name", ["torch_gauss", "torch_production_fit", "torch_bootstrap", "torch_cv_feat"]
)
def test_twins_need_cuda_unless_told(monkeypatch, name):
    """The default device is the card: without CUDA a twin raises, never
    runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _load(name).main(["--frames", "20"] if name != "torch_bootstrap" else [])


@pytest.mark.parametrize(
    "name, args",
    [("torch_gauss", ["--pdb"]), ("torch_production_fit", ["--pdb"]),
     ("torch_cv_feat", ["--pdb"]), ("torch_bootstrap", ["--data"])],
)
def test_twins_refuse_a_missing_file(tmp_path, name, args):
    with pytest.raises(SystemExit, match="missing"):
        _load(name).main(["--device", "cpu", *args, str(tmp_path / "absent")])


# ---- parity with the JAX API -------------------------------------------------


def _jax_draws(seed: int):
    """The k-th standard-normal draw of a fresh JCondNormal(seed), k = 0, 1, ..."""
    cache = {}

    def draw(k, shape):
        if (k, shape) not in cache:
            key, _ = jrandom.split(jrandom.PRNGKey(seed))
            for _ in range(k + 1):
                key, sub = jrandom.split(key)
            cache[(k, shape)] = np.asarray(jrandom.normal(sub, shape))
        return cache[(k, shape)]

    return draw


def test_gauss_matches_jax(monkeypatch, one_thread):
    """The twin's residuals on its default system against JAX's
    ``project_forces`` with the JAX example's arguments: the linear one
    within 1e-5 relative; the Gaussian ones with every augmenter of the port
    fed the draws of the JAX augmenter of the same seed (its k-th draw for
    the port's k-th), within 1e-4 relative (the linear fit's parity,
    tests/test_torch_qplinear.py)."""
    jax_draw = _jax_draws(42)
    gens, counts = [], {}

    def draw(gen, shape, device, dtype):
        if gen not in gens:
            gens.append(gen)
        k = counts[gens.index(gen)] = counts.get(gens.index(gen), -1) + 1
        return torch.tensor(jax_draw(k, tuple(shape)), device=device, dtype=dtype)

    monkeypatch.setattr(paug, "_standard_normal", draw)
    frames = 150
    got = _load("torch_gauss").main(["--device", "cpu", "--frames", str(frames)])
    assert got["noised_shape"] == got["premapped_shape"] == (frames, 10, 3)

    fix = standalone_fixture(frames, seed=11)
    cmap = jt.LinearMap(fix["cg_sites"], n_fg_sites=175)
    kw = dict(coords=fix["coords"], forces=fix["forces"], coord_map=cmap,
              constrained_inds=set(fix["constraint_groups"]))
    expect = {"linear": jt.project_forces(**kw)["residual"]}
    for name in ("joptgauss", "stagedjoptgauss", "stagedjslicegauss", "stagedjforcegauss"):
        expect[name] = jt.project_forces(
            method=getattr(jt, f"{name}_map"), var=0.002, kbt=KBT, seed=42, **kw
        )["residual"]
    assert got["residuals"]["linear"] == pytest.approx(float(expect["linear"]), rel=1e-5)
    for name, value in expect.items():
        assert got["residuals"][name] == pytest.approx(float(value), rel=1e-4), name


def _objective_gap(gram, rows, coefs):
    """(J(c) - J(c_w)) / J(c_w) for J(c) = sum_s c_s^T P_s c_s, with c_w the
    float64 minimizer of J subject to A c_w = A c (chip_smoke.objective_gap)."""
    from aggforce_torch.ops.eqp import eqp_solve_host

    target = np.einsum("smn,sn->sm", rows, coefs)
    witness = np.stack([
        eqp_solve_host(gram[s], rows[s], target[s][:, None])[:, 0]
        for s in range(gram.shape[0])
    ])

    def objective(c):
        return float(np.einsum("si,sij,sj->", c, gram, c))

    return (objective(coefs) - objective(witness)) / objective(witness)


def test_bootstrap_matches_jax_batch(tmp_path, one_thread):
    """``--data`` with an npz of the upstream layout, against the JAX batch
    fits with the JAX example's arguments and the same seeds.

    On this input the maps are not pinned to 2e-3 * mean|f|
    (tests/test_torch_fusedfeat.py:115): the regularized site Grams have
    condition ~3e6 (chip_smoke.py phase 15 prints it), so fits that meet
    the constraints part along weakly pinned directions, in either package.
    So each port map is held to its objective instead, within 1e-4 of the
    float64 optimum for the constraint values it meets (chip_smoke's gate),
    and the example's observable, each map's mean squared mapped force, to
    JAX's within 1e-3 relative.
    """
    from aggforce_torch import LinearMap
    from aggforce_torch.ops.gram import site_grams_plain
    from aggforce_torch.qp.fusedfeat import GBFeatSpec, _fit_parts, group_factorization

    fix = synthesize_dimer_fixture(n_frames=300, seed=3)
    path = tmp_path / "dimer.npz"
    np.savez(path, coords=fix["coords"], Fs=fix["forces"])
    got = _load("torch_bootstrap").main(
        ["--device", "cpu", "--n-maps", "4", "--window", "2", "--data", str(path)]
    )
    assert got["source"] == str(path)
    coords, forces = fix["coords"], fix["forces"]
    maps = jax_batch(
        jt.Trajectory(coords=jnp.asarray(coords), forces=jnp.asarray(forces)),
        jt.LinearMap([[0], [3]], n_fg_sites=6), kbt=KBT,
        spec=JaxSpec(outer=1.0, inner=0.0, n_basis=5, width=1.0), seeds=range(4),
        constraints=set(), l2_regularization=1e1, chunk_size=256, flush_every=2,
    )
    assert len(got["maps"]) == len(maps) == 4
    msf = [float(np.mean(np.asarray(m.map_arrays(coords, forces)[1]) ** 2)) for m in maps]
    np.testing.assert_allclose(got["msf"], msf, rtol=1e-3)

    spec = GBFeatSpec(outer=1.0, inner=0.0, n_basis=5, width=1.0)
    cmap = LinearMap([[0], [3]], n_fg_sites=6)
    geom = group_factorization(cmap, spec, set())

    def f64(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float64)

    xyz = f64(coords)
    for seed, pmap in enumerate(got["maps"]):
        frames = np.random.default_rng(seed).choice(len(coords), size=20, replace=False)
        gram, rows, _ = (x.numpy() for x in _fit_parts(
            xyz, f64(forces), torch.ones(len(coords), dtype=torch.float64), xyz[frames],
            f64(cmap.standard_matrix), *(f64(geom[k]) for k in
                                        ("group_mean", "onehot", "counts", "centers")),
            KBT, 1e1, spec, site_grams_plain,
        ))
        coefs = np.stack(pmap.force_map.tags["coef_list"]).astype(np.float64)
        assert _objective_gap(gram, rows, coefs) <= 1e-4, seed


def test_production_map_loads_in_jax(tmp_path, one_thread):
    """The map the twin saved, loaded by JAX's ``load_tmap``, maps the same
    forces within 1e-6 of their largest entry."""
    got = _load("torch_production_fit").main(
        ["--device", "cpu", "--frames", "120", "--workdir", str(tmp_path)]
    )
    assert got["reload_max_diff"] == 0.0
    coords, forces = got["coords"][:32], got["forces"][:32]
    _, expect = got["tmap"].map_arrays(coords, forces)
    _, jf = jax_load_tmap(str(tmp_path / "force_map.npz")).map_arrays(coords, forces)
    np.testing.assert_allclose(np.asarray(jf), expect, atol=1e-6 * np.abs(expect).max())


# ---- the --pdb path, on a tiny PDB -----------------------------------------

_RESIDUE = [  # name, x, y, z (Å) of one glycine-like residue
    ("N", -0.966, 0.493, 1.500), ("H", -1.800, 0.100, 1.200),
    ("CA", 0.257, 0.418, 0.692), ("HA", 0.300, 1.300, 0.100),
    ("C", -0.094, 0.017, -0.716), ("O", -1.056, -0.682, -0.923),
]


@pytest.fixture(scope="module")
def tiny_pdb(tmp_path_factory):
    """Four residues (24 atoms, 4 C-alphas, 8 bonded hydrogen pairs)."""
    lines = []
    for res in range(4):
        for name, x, y, z in _RESIDUE:
            serial = len(lines) + 1
            lines.append(
                f"ATOM  {serial:5d}  {name:<3s} GLY A{res + 1:4d}    "
                f"{x + 3.8 * res:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00           {name[0]}"
            )
    path = tmp_path_factory.mktemp("pdb") / "tiny.pdb"
    path.write_text("\n".join(lines) + "\nEND\n")
    return str(path)


def _jax_example_main(monkeypatch, name, pdb, argv):
    """Run the JAX example's ``main`` with its module-level PDB pointed at
    ``pdb`` and ``argv`` as its command line; returns its standard output."""
    module = _load(name)
    monkeypatch.setattr(module, "PDB", pdb)
    monkeypatch.setattr(sys, "argv", [name, *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module.main()
    return out.getvalue()


def _printed(text: str, prefix: str) -> float:
    line = next(x for x in text.splitlines() if x.strip().startswith(prefix))
    return float(line.split(prefix)[1].split()[0])


def test_gauss_pdb_path_matches_jax_example(monkeypatch, tiny_pdb, one_thread):
    got = _load("torch_gauss").main(["--device", "cpu", "--pdb", tiny_pdb, "--frames", "80"])
    assert got["system"] == f"pdb {tiny_pdb}"
    text = _jax_example_main(monkeypatch, "gauss", tiny_pdb, ["--frames", "80"])
    assert "staged save/load OK" in text
    # printed with 4 decimals
    assert got["residuals"]["linear"] == pytest.approx(
        _printed(text, "linear"), rel=1e-5, abs=5e-5
    )


def test_cv_feat_pdb_path_matches_jax(monkeypatch, tiny_pdb, tmp_path, one_thread):
    """The twin's table against JAX's ``project_forces_grid_cv`` with the
    JAX example's arguments (scores and sds within tests/test_torch_cv.py's
    tolerances, the same best point), its control score against the JAX
    example's, and its CSV against its rows."""
    frames, folds = 150, 3
    csv_path = tmp_path / "table.csv"
    got = _load("torch_cv_feat").main([
        "--device", "cpu", "--pdb", tiny_pdb, "--frames", str(frames),
        "--folds", str(folds), "--quick", "--csv", str(csv_path),
    ])
    jax_example = _load("cv_feat")
    fix = jax_protein_fixture(tiny_pdb, n_frames=frames, seed=31)
    constraints = jax_constraints(fix["coords"][:10], threshold=1e-3)
    assert got["constraints"] == constraints and len(constraints) == 8
    feats = jax_example.gen_feater_grid(n_basis=[5, 7], outer=[8.0])
    expect = jax_grid_cv(
        cv_arg_dict={"featurizer": feats, "l2_regularization": [1e1, 1e3]},
        coords=fix["coords"], forces=fix["forces"], n_folds=folds,
        coord_map=jt.LinearMap(ca_map_from_pdb(tiny_pdb), n_fg_sites=n_atoms(tiny_pdb)),
        constrained_inds=constraints, method=jax_example.qp_feat_linear_map,
        kbt=float(fix["kbt"]), rng=np.random.default_rng(0),
    )
    table = {
        (row["n_basis"], row["l2"]): (row["scores"], row["sd"], row["n_runs"])
        for row in got["rows"]
    }
    assert len(table) == len(expect["scores"]) == 4
    for label, score in expect["scores"].items():
        key = (label.featurizer.featurizers[1].kwargs["n_basis"], label.l2_regularization)
        g_score, g_sd, g_n = table[key]
        assert g_n == expect["n_runs"][label] == folds
        assert g_score == pytest.approx(score, rel=1e-4)
        assert g_sd == pytest.approx(expect["sds"][label], rel=1e-3)
    jax_best = min(expect["scores"], key=expect["scores"].get)
    best = got["best"]
    assert best.l2_regularization == jax_best.l2_regularization
    assert (best.featurizer.featurizers[1].kwargs
            == jax_best.featurizer.featurizers[1].kwargs)
    assert [r["scores"] for r in got["rows"]] == sorted(r["scores"] for r in got["rows"])

    with open(csv_path, newline="") as fh:
        written = list(csv.reader(fh))
    assert written[0] == ["", "n_basis", "l2", "scores", "sd"]
    assert [float(r[3]) for r in written[1:]] == [r["scores"] for r in got["rows"]]

    text = _jax_example_main(
        monkeypatch, "cv_feat", tiny_pdb,
        ["--frames", str(frames), "--folds", str(folds), "--quick"],
    )
    assert got["control_score"] == pytest.approx(
        _printed(text, "static-map control holdout residual:"), rel=1e-4, abs=5e-5
    )
