#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when it
fails:

1. environment: torch/CUDA versions, the card's name and power limit, TF32;
2. build: compile every CUDA kernel of the path from ``aggforce_torch/csrc``;
3. each kernel against its plain torch version on the card, at the main
   path's shapes and at edge shapes, and the config-#3 Gram against a
   float64 sum of the same rows;
4. the main path: ``aggforce_torch.project_forces`` with the featurized
   method on a 10,000-frame synthetic trajectory at the full width of
   config #3 (175 atoms, 30 constraint pairs, 10 cg sites, n_basis=7):
   the kernel must have launched, the mapped forces must be finite and the
   constraints met; the kernel fit's and the plain fit's objectives must
   lie near float64 witnesses (see ``fit_checks``), and so must the
   site-blocked fit (``site_block=3``, a ragged last block); a small input
   holds the kernel fit, the plain fit and the blocked fit to
   2e-3 * mean|f| of each other. A planted fault (a Gram without the
   divergence term) must fail the Gram and the objective gates;
5. times: first fit, steady-state fits and a profiled fit's device time by
   kernel, each kernel (and its build and product stages) against its plain
   version, its library yardstick and two bounds (3xTF32 on the tensor
   cores, the route it takes, and fp32 on the CUDA cores), peak device
   memory;
6. the sweep path: ``fused_gb_linear_map_blocked`` at the full sweep width
   (1,500 atoms, 375 constraint pairs, 66 cg sites, n_basis=7, so
   K_exp = 9,000; 20,000 frames; 6 sites per block, 11 blocks). The tiled
   kernel against its plain version at sweep width and at edge shapes, and
   against a float64 sum (the planted fault must fail); the fit must launch
   the tiled kernel once per block and map to finite forces; its first
   block must lie near a float64 witness solved on the card (the planted
   fault must not), and its peak device memory must stay within 24 GiB;
   then the fit's times and profile, and the tiled kernel's times;
7. one JSON line listing every kernel; the last line is the result.

The fixtures are the JAX bench's standalone geometry (bench.py:290-307)
and its sweep geometry (bench.py:415-530), made from fixed seeds; nothing is
read from outside the repository.
"""

import json
import subprocess
import sys
import time

_T_START = time.perf_counter()

N_FRAMES = 10_000
KBT = 0.6955215
L2 = 1e3
OUTER, N_BASIS, WIDTH = 8.0, 7, 1.0
# gate of the kernel Gram against a float64 sum of the same rows, relative
# to the largest entry. A single TF32 pass lands near 1e-5 there; the
# kernels' 3xTF32 split with fp64 chunk totals, like fp32 sums, near 1e-7.
GRAM_REL_LIMIT = 1e-6
# gate of a fit's objective against the float64 optimum for the constraint
# values the fit meets, relative. The witness itself is good to ~1e-5 on
# these near-dependent constraint rows (the float64 host oracle's own
# solution sits that far from its witness), and a fit on a Gram without
# the divergence term lands above 1e-2.
J_GAP_LIMIT = 1e-4
# the sweep path (bench.py:415-530): its own kbT, and sites fitted per block
SWEEP_FRAMES = 20_000
SWEEP_ATOMS = 1_500
SWEEP_KBT = 0.7
SWEEP_SITE_BLOCK = 6
# published H100 SXM peaks (NVIDIA data sheet) used for the lower bounds
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# products per fp32 product in the kernels' 3xTF32 split (lo*hi, hi*lo, hi*hi)
TF32_PASSES = 3
# the sweep fit's device-memory ceiling
SWEEP_PEAK_LIMIT_GIB = 24.0


def log(msg: str) -> None:
    """Print a line, prefixed with the process seconds so far."""
    print(f"[{time.perf_counter() - _T_START:7.1f}s] {msg}", flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def phase_environment(torch) -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    log(smi)
    log(f"device: {torch.cuda.get_device_name(0)}  count: "
        f"{torch.cuda.device_count()}")
    log(f"torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    return smi


def phase_build():
    from aggforce_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    for src, lib in libs.items():
        log(f"built {src} -> {lib.name}")
        for line in _build.last_build["ptxas"].get(src, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"build seconds: {time.perf_counter() - t0:.3f} "
        f"(nvcc {_build.last_build['seconds']:.3f})")


def fixture():
    import numpy as np

    from aggforce_torch import LinearMap
    from aggforce_torch.utils.synth import synthesize_trajectory

    rng = np.random.default_rng(0)
    n_sites = 175
    base = rng.normal(scale=0.5, size=(n_sites, 3))
    groups = [frozenset((i, i + 1)) for i in range(0, 60, 2)]
    cmap = LinearMap([[i] for i in range(0, n_sites, 18)], n_fg_sites=n_sites)
    coords, forces = synthesize_trajectory(base, groups, N_FRAMES, seed=2024)
    return coords, forces, cmap, groups


def packed_operands(torch, coords, forces, cmap, groups, spec):
    """The Gram kernel's operands exactly as the main path packs them."""
    from aggforce_torch.ops.gram import pack_operands
    from aggforce_torch.qp.fusedfeat import group_factorization

    geom = group_factorization(cmap, spec, set(groups))

    def dev(x):
        return torch.as_tensor(x, dtype=torch.float32, device="cuda")

    mask = torch.ones(coords.shape[0], dtype=torch.float32, device="cuda")
    ops = pack_operands(
        dev(coords), dev(forces), mask, dev(cmap.standard_matrix),
        dev(geom["group_mean"]), dev(geom["onehot"]), dev(geom["counts"]),
        KBT, spec.n_basis, dev(geom["centers"]),
    )
    gpos, cg, fg, centers_flat, kcounts = ops
    return gpos, cg, fg, mask, centers_flat, kcounts


def random_operands(torch, g, t, s, n_basis, seed):
    """Edge-shape operands in the kernel's layout, with masked frames."""
    import numpy as np

    from aggforce_torch.ops.gram import pack_operands

    rng = np.random.default_rng(seed)
    n = 2 * g + 3
    coords = rng.normal(size=(t, n, 3))
    forces = rng.normal(size=(t, n, 3))
    mask = np.ones(t)
    mask[-(t // 5 + 1):] = 0.0
    cmap = rng.normal(size=(s, n))
    onehot = np.zeros((n, g))
    onehot[np.arange(n), np.arange(n) % g] = 1.0
    counts = onehot.sum(0)
    group_mean = (onehot / counts).T
    centers = np.linspace(0.1, 2.5, n_basis)

    def dev(x):
        return torch.as_tensor(x, dtype=torch.float32, device="cuda")

    maskd = dev(mask)
    gpos, cg, fg, cf, kc = pack_operands(
        dev(coords), dev(forces), maskd, dev(cmap), dev(group_mean),
        dev(onehot), dev(counts), 0.7, n_basis, dev(centers),
    )
    return gpos, cg, fg, maskd, cf, kc


def compare_kernel(torch, ops, n_basis, label):
    from aggforce_torch.ops.gram import site_grams, site_grams_plain

    got = site_grams(*ops, n_basis, WIDTH, 1e-3)
    torch.cuda.synchronize()
    ref = site_grams_plain(*ops, n_basis, WIDTH, 1e-3)
    err = float((got - ref).abs().max())
    atol = 3e-4 * (float(ref.abs().max()) + 1.0)
    finite = bool(torch.isfinite(got).all())
    log(f"site_grams vs plain [{label}] shape={tuple(got.shape)} "
        f"max_abs_err={err:.6g} atol={atol:.6g} finite={finite}")
    if not finite or not err <= atol:
        fail(f"site_grams disagrees with its plain version at {label}")
    return err


def without_divergence(gpos, cg, fg, mask, centers_flat, kbt_counts_flat, *rest, **kw):
    """The plain Gram with the divergence term dph dropped: a planted fault
    that each gate of this script must reject."""
    from aggforce_torch.ops.gram import site_grams_plain

    return site_grams_plain(
        gpos, cg, fg, mask, centers_flat,
        kbt_counts_flat.new_zeros(kbt_counts_flat.shape), *rest, **kw,
    )


def gram_error_vs_float64(ops, n_basis):
    """Gate the kernel's float32 Gram against the same arithmetic summed in
    float64: max abs error <= GRAM_REL_LIMIT * largest entry. The plain
    version is printed beside it, and a Gram without the divergence term
    must fail the same test."""
    from aggforce_torch.ops.gram import site_grams, site_grams_plain

    exact = site_grams_plain(*(x.double() for x in ops), n_basis, WIDTH, 1e-3)
    peak = float(exact.abs().max())
    rel = {}
    for name, fn in (
        ("kernel", site_grams),
        ("plain", site_grams_plain),
        ("planted fault: no divergence term", without_divergence),
    ):
        err = float((fn(*ops, n_basis, WIDTH, 1e-3).double() - exact).abs().max())
        rel[name] = err / peak
        log(f"{name} Gram vs float64 sum: max abs err / max entry = "
            f"{err / peak:.3e} (limit {GRAM_REL_LIMIT:.0e})")
    if not rel["kernel"] <= GRAM_REL_LIMIT:
        fail("the kernel Gram is further than the limit from a float64 sum")
    if not rel["planted fault: no divergence term"] > GRAM_REL_LIMIT:
        fail("the Gram check does not reject a Gram without the divergence term")


def phase_kernels(torch, coords, forces, cmap, groups, spec):
    ops = packed_operands(torch, coords, forces, cmap, groups, spec)
    errs = [compare_kernel(torch, ops, spec.n_basis, f"config #3, T={N_FRAMES}")]
    gram_error_vs_float64(ops, spec.n_basis)
    for i, (g, t, s, nb) in enumerate(
        [(5, 37, 1, 4), (17, 1007, 3, 7), (145, 333, 2, 7), (16, 16, 1, 1)]
    ):
        edge = random_operands(torch, g, t, s, nb, seed=100 + i)
        label = f"G_pad={edge[0].shape[2]} T={t} S={s} n_basis={nb} masked"
        errs.append(compare_kernel(torch, edge, nb, label))
    return ops, max(errs)


def cuda_ms(torch, fn, reps):
    """Mean device milliseconds of ``fn`` over ``reps`` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def stage_ms(torch, tiled, args, n_chunks):
    """Device milliseconds of one launch of a Gram kernel by stage, the row
    build (``site_grams_build``) and the tensor-core product
    (``site_grams_product``), each launched once per frame chunk: every
    launch timed by CUDA events that the C entry records between them
    (``ops.gram.stage_times``); ``kernel_report`` holds their sum to the
    launch's time."""
    from aggforce_torch.ops.gram import stage_times

    torch.cuda.synchronize()
    build, product = stage_times(tiled, *args)
    log(f"stages of one launch ({n_chunks} chunks, CUDA events between the "
        f"launches): build {build:.3f} ms, product {product:.3f} ms")
    return {"build": build, "product": product}


def kernel_report(name, ms, stages, flops, n_bytes, library_ms, plain_ms):
    """Log a Gram kernel's time against its bounds and yardstick; return the
    JSON fields. ``bound_ms`` is the route the kernel takes: TF32_PASSES
    tensor-core products per fp32 product at the TF32 peak, or the bytes if
    they take longer; ``fp32_bound_ms``, computed the same way from the same
    inputs, is the fp32 CUDA-core route, kept beside it."""
    tc_ms = TF32_PASSES * flops / PEAK_TF32_FLOPS * 1e3
    fp32_ms = flops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = n_bytes / PEAK_BYTES * 1e3
    bound_ms = max(tc_ms, bytes_ms)
    bound_by = "operations" if tc_ms >= bytes_ms else "bytes"
    log(f"{name}: {ms:.3f} ms per launch, {flops / ms / 1e9:.2f} TFLOP/s of unique "
        f"entries ({TF32_PASSES * flops / ms / 1e9:.2f} TFLOP/s of TF32 products); "
        f"build stage {stages['build']:.3f} ms, product stage "
        f"{stages['product']:.3f} ms ({TF32_PASSES * flops / stages['product'] / 1e9:.2f} "
        f"TFLOP/s TF32)")
    staged = stages["build"] + stages["product"]
    if not abs(staged - ms) <= 0.05 * ms:
        fail(f"{name}: the stages add up to {staged:.3f} ms, not within 5% of the "
             f"launch's {ms:.3f} ms")
    log(f"{name}: bound {bound_ms:.3f} ms ({bound_by}; {TF32_PASSES}x{flops:.4g} "
        f"TF32 FLOP at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s, {n_bytes:.4g} B at "
        f"{PEAK_BYTES / 1e12:.2f} TB/s), fp32 CUDA-core bound {fp32_ms:.3f} ms; "
        f"{ms / bound_ms:.2f}x the bound; plain {plain_ms:.3f} ms; torch.bmm "
        f"yardstick {library_ms:.3f} ms, which the kernel "
        f"{'beats' if ms < library_ms else 'does NOT beat'} ({library_ms / ms:.2f}x)")
    return dict(
        ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
        bound_by=bound_by, fp32_bound_ms=fp32_ms, build_ms=stages["build"],
        product_ms=stages["product"],
    )


def plain_fit(np, coords, forces, cmap, groups, featurizer, **kwargs):
    """The same fit with the plain Gram instead of the kernel: (map, forces)."""
    from aggforce_torch import Trajectory
    from aggforce_torch.qp.fusedfeat import (
        fused_gb_linear_map,
        recognize_canonical_featurizer,
    )

    plain_map = fused_gb_linear_map(
        Trajectory(coords=coords, forces=forces), cmap, kbt=KBT,
        spec=recognize_canonical_featurizer(featurizer),
        constraints=set(groups), l2_regularization=L2,
        constraint_rng=np.random.default_rng(7), use_kernel=False, **kwargs,
    )
    return plain_map, plain_map.map_arrays(coords, forces)[1]


def fit_problem(torch, np, coords, forces, cmap, groups, spec, dtype, gram_fn):
    """The main path's per-site QP on the card, (Gram + l2, constraint rows,
    targets), built by the fit's own assembly in ``dtype`` with ``gram_fn``
    on the 20 constraint frames that ``fused_gb_linear_map`` draws from
    ``constraint_rng=np.random.default_rng(7)``."""
    from aggforce_torch.qp.fusedfeat import _fit_parts, group_factorization

    geom = group_factorization(cmap, spec, set(groups))
    frame_idx = np.random.default_rng(7).choice(len(coords), size=20, replace=False)

    def dev(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device="cuda")

    xyz = dev(coords)
    return _fit_parts(
        xyz, dev(forces), torch.ones(len(coords), dtype=dtype, device="cuda"),
        xyz[torch.as_tensor(frame_idx, device="cuda")], dev(cmap.standard_matrix),
        dev(geom["group_mean"]), dev(geom["onehot"]), dev(geom["counts"]),
        dev(geom["centers"]), KBT, L2, spec, gram_fn,
    )


def device_solve(gram, a_rows, b):
    """(S, K_exp) coefficients from the main path's shared-factor solver,
    with the fit's defaults (delta 1e-6, 40 refinement sweeps)."""
    from aggforce_torch.ops.eqp import batched_eqp_solve_shared

    coefs = batched_eqp_solve_shared(
        gram, a_rows[None], b[None, ..., None], delta=1e-6, iters=40
    )
    return coefs[0, ..., 0].double().cpu().numpy()


def objective_gap(np, gram, rows, coefs):
    """How far a fit is from optimal for the constraint values it meets.

    J(c) = sum_s c_s^T P_s c_s with P the float64 Gram + l2 (the fit's
    objective: summed squared mapped forces plus the l2 term). The witness
    c_w minimizes J in float64 on the host (``eqp_solve_host``) subject to
    A c_w = A c. Returns ((J(c) - J(c_w)) / J(c_w), c_w).
    """
    from aggforce_torch.ops.eqp import eqp_solve_host

    target = np.einsum("smn,sn->sm", rows, coefs)
    witness = np.stack([
        eqp_solve_host(gram[s], rows[s], target[s][:, None])[:, 0]
        for s in range(gram.shape[0])
    ])

    def objective(c):
        return float(np.einsum("si,sij,sj->", c, gram, c))

    return (objective(coefs) - objective(witness)) / objective(witness), witness


def fit_checks(
    torch, np, coords, forces, cmap, groups, spec, kernel_map, plain_map, blocked_map
):
    """Gate the config-#3 fit against a float64 witness, and measure where
    the kernel fit and the plain fit part.

    Gates: the kernel fit, the plain fit and the site-blocked fit each lie
    within J_GAP_LIMIT of the float64 optimum for the constraint values they
    meet, and a fit on a Gram without the divergence term does not. The mapped forces are only
    printed: the 200 sampled constraint rows of a site are near-dependent
    (the rank printed below), so fits that meet them to well inside the
    solver tolerance part by percents of mean|f| at the worst frame, even
    when solved in float64. Every number is printed before a gate fails.
    """
    from aggforce_torch.ops.eqp import eqp_solve_host
    from aggforce_torch.ops.gram import site_grams, site_grams_plain
    from aggforce_torch.qp.fusedfeat import FusedGBMap, group_factorization

    geom = group_factorization(cmap, spec, set(groups))

    def forces_of(coefs):
        return FusedGBMap(
            coefs=np.asarray(coefs, dtype=np.float32),
            cmap_mat=np.asarray(cmap.standard_matrix, dtype=np.float32),
            onehot=geom["onehot"], centers=geom["centers"], kbt=KBT, spec=spec,
            device="cuda",
        )(forces, coords)

    def problem(dtype, gram_fn):
        return fit_problem(
            torch, np, coords, forces, cmap, groups, spec, dtype, gram_fn
        )

    gram64, rows64, b64 = problem(torch.float64, site_grams_plain)
    gram, rows, b = (x.cpu().numpy() for x in (gram64, rows64, b64))
    coefs = {
        "kernel fit (main path)": np.stack(kernel_map.force_map.tags["coef_list"]),
        "plain fit": np.stack(plain_map.force_map.tags["coef_list"]),
        "blocked fit (site_block=3, tiled kernel)": np.stack(
            blocked_map.force_map.tags["coef_list"]
        ),
        # solved in float64 so that the fault, not a failed solve, is seen
        "planted fault: no divergence term": device_solve(
            problem(torch.float32, without_divergence)[0].double(), rows64, b64
        ),
    }
    for name, fn in (("kernel", site_grams), ("plain", site_grams_plain)):
        coefs[f"{name} Gram, float64 solve"] = device_solve(
            problem(torch.float32, fn)[0].double(), rows64, b64
        )
    coefs["float64 host oracle, A c = b"] = np.stack([
        eqp_solve_host(gram[s], rows[s], b[s][:, None])[:, 0]
        for s in range(gram.shape[0])
    ])
    f = {name: forces_of(c) for name, c in coefs.items()}
    scale = float(np.abs(f["plain fit"]).mean())

    def dev(x, y):
        d = np.abs(x - y)
        return float(d.max()) / scale, float(np.sqrt((d**2).mean())) / scale

    norm = np.linalg.norm(rows, axis=2)
    gaps = {}
    for name, c in coefs.items():
        gaps[name], witness = objective_gap(np, gram, rows, c)
        viol = float(np.abs((np.einsum("smn,sn->sm", rows, c) - b) / norm).max())
        msf = float(np.mean(f[name] ** 2))
        log(f"  {name}: objective gap to its witness {gaps[name]:+.3e} "
            f"(limit {J_GAP_LIMIT:.0e}); mapped forces vs witness max/rms "
            f"{'%.3e / %.3e' % dev(f[name], forces_of(witness))} mean|f|; "
            f"constraint violation {viol:.2e}; mean square force {msf:.6f}")
    sv = np.linalg.svd(rows[0] / norm[0][:, None], compute_uv=False)
    log(f"  site 0: {rows.shape[1]} equilibrated constraint rows, singular "
        f"values {sv[0]:.3g} ... {sv[-1]:.3g}, {int((sv > 1e-6 * sv[0]).sum())} "
        f"above 1e-6 of the largest")
    pairs = [
        ("kernel fit (main path)", "plain fit"),
        ("kernel Gram, float64 solve", "plain Gram, float64 solve"),
        ("kernel Gram, float64 solve", "kernel fit (main path)"),
        ("blocked fit (site_block=3, tiled kernel)", "kernel fit (main path)"),
        ("float64 host oracle, A c = b", "kernel Gram, float64 solve"),
    ]
    for x, y in pairs:
        log(f"  {x} vs {y}: mapped forces max/rms "
            f"{'%.3e / %.3e' % dev(f[x], f[y])} mean|f|")
    failed = [
        f"{name} objective gap {gaps[name]:.3e} above {J_GAP_LIMIT:.0e}"
        for name in (
            "kernel fit (main path)", "plain fit",
            "blocked fit (site_block=3, tiled kernel)",
        )
        if not gaps[name] <= J_GAP_LIMIT
    ]
    if not gaps["planted fault: no divergence term"] > J_GAP_LIMIT:
        failed.append("the objective gate does not reject the planted fault")
    if failed:
        fail("; ".join(failed))


def small_input_parity(np):
    """Kernel fit vs plain fit, and blocked fit (site_block=2, the tiled
    kernel, a ragged last block) vs the unblocked kernel fit, on the card on
    a small, well-conditioned input: mapped forces within 2e-3 * mean|f|
    (tests/test_pallas_gram.py:111-112)."""
    import aggforce_torch
    from aggforce_torch import Curry, LinearMap, Multifeaturize, Trajectory, gb_feat, id_feat
    from aggforce_torch.qp import fused_gb_linear_map_blocked, qp_feat_linear_map
    from aggforce_torch.qp.fusedfeat import recognize_canonical_featurizer
    from aggforce_torch.utils.synth import synthesize_trajectory

    n = 24
    base = np.random.default_rng(0).normal(scale=0.5, size=(n, 3))
    groups = [frozenset((i, i + 1)) for i in range(0, 8, 2)]
    cmap = LinearMap([[i] for i in range(0, n, 9)], n_fg_sites=n)
    coords, forces = synthesize_trajectory(base, groups, 256, seed=3)
    featurizer = Multifeaturize([id_feat, Curry(gb_feat, outer=2.0, n_basis=4)])
    mapped = aggforce_torch.project_forces(
        coords, forces, cmap, constrained_inds=set(groups),
        method=qp_feat_linear_map, featurizer=featurizer, kbt=KBT,
        l2_regularization=L2, n_constraint_frames=10,
        constraint_rng=np.random.default_rng(7),
    )["mapped_forces"]
    _, plain = plain_fit(
        np, coords, forces, cmap, groups, featurizer, n_constraint_frames=10
    )
    blocked = fused_gb_linear_map_blocked(
        Trajectory(coords=coords, forces=forces), cmap, kbt=KBT,
        spec=recognize_canonical_featurizer(featurizer), constraints=set(groups),
        l2_regularization=L2, n_constraint_frames=10,
        constraint_rng=np.random.default_rng(7), site_block=2,
    ).map_arrays(coords, forces)[1]
    bound = 2e-3 * float(np.abs(plain).mean())
    failed = []
    for name, x, y in (
        ("kernel fit vs plain fit", mapped, plain),
        ("blocked fit (site_block=2) vs kernel fit", blocked, mapped),
    ):
        diff = float(np.abs(x - y).max())
        log(f"small input (24 atoms, 3 sites, T=256): {name} max |df| = "
            f"{diff:.6g}, bound 2e-3*mean|f| = {bound:.6g}")
        if not diff <= bound:
            failed.append(f"{name} disagree on the small input")
    if failed:
        fail("; ".join(failed))


def phase_main_path(torch, np, coords, forces, cmap, groups):
    import aggforce_torch
    from aggforce_torch import Curry, Multifeaturize, gb_feat, id_feat
    from aggforce_torch import Trajectory
    from aggforce_torch.ops.gram import site_grams, site_grams_tiled
    from aggforce_torch.qp import fused_gb_linear_map_blocked, qp_feat_linear_map
    from aggforce_torch.qp.fusedfeat import recognize_canonical_featurizer

    featurizer = Multifeaturize(
        [id_feat, Curry(gb_feat, outer=OUTER, n_basis=N_BASIS, width=WIDTH)]
    )
    torch.cuda.reset_peak_memory_stats()
    site_grams.launches = site_grams_tiled.launches = 0
    t0 = time.perf_counter()
    result = aggforce_torch.project_forces(
        coords, forces, cmap,
        constrained_inds=set(groups),
        method=qp_feat_linear_map,
        featurizer=featurizer,
        kbt=KBT,
        l2_regularization=L2,
        constraint_rng=np.random.default_rng(7),
    )
    torch.cuda.synchronize()
    first_fit_s = time.perf_counter() - t0
    launches = site_grams.launches
    tiled_launches = site_grams_tiled.launches
    peak_bytes = torch.cuda.max_memory_allocated()
    log(f"main path: project_forces {first_fit_s:.3f} s, site_grams launches "
        f"{launches}, site_grams_tiled launches {tiled_launches}, process "
        f"seconds to first fitted map "
        f"{time.perf_counter() - _T_START:.3f}")
    if launches < 1:
        fail("the main path did not launch site_grams")

    tmap = result["tmap"]
    mapped = np.asarray(result["mapped_forces"])
    resid = tmap.force_map.tags["solver_resid"]
    log(f"mapped forces {mapped.shape} finite={bool(np.isfinite(mapped).all())} "
        f"solver_resid={resid:.3e} escalated_to_float64="
        f"{tmap.force_map.tags['escalated']} residual={result['residual']:.6g}")
    if mapped.shape != (N_FRAMES, cmap.n_cg_sites, 3):
        fail(f"mapped forces have shape {mapped.shape}")
    if not np.isfinite(mapped).all():
        fail("mapped forces are not finite")
    if not resid <= 1e-4:
        fail(f"solver residual {resid} above 1e-4")

    spec = recognize_canonical_featurizer(featurizer)
    plain_map, _ = plain_fit(np, coords, forces, cmap, groups, featurizer)
    blocked_map = fused_gb_linear_map_blocked(
        Trajectory(coords=coords, forces=forces), cmap, kbt=KBT, spec=spec,
        constraints=set(groups), l2_regularization=L2,
        constraint_rng=np.random.default_rng(7), site_block=3,
    )
    tags = blocked_map.force_map.tags
    log(f"blocked fit at config #3 (site_block=3): solver_resid "
        f"{tags['solver_resid']:.3e}, escalated sites {tags['escalated']}")
    log("config #3 fit against float64 witnesses:")
    fit_checks(
        torch, np, coords, forces, cmap, groups, spec, tmap, plain_map, blocked_map
    )
    small_input_parity(np)
    return spec, launches, first_fit_s, peak_bytes


def fit_breakdown(torch, fit, fit_s, top=12):
    """One steady-state fit under torch.profiler: device time by kernel, the
    kernels' total against the profiled fit's own wall clock (the device's
    idle share) and against the unprofiled fit time ``fit_s``, and the
    device time by kind of kernel."""
    from torch.profiler import ProfilerActivity, profile

    # device activity only: with CPU ops recorded too, key_averages() spent
    # minutes on the sweep fit's trace
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fit()
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    kernels = [
        (e.key, e.self_device_time_total, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    log(f"profile aggregated in {time.perf_counter() - t0 - wall_s:.1f} s")
    busy_s = sum(k[1] for k in kernels) / 1e6
    log(f"profiled fit: wall {wall_s * 1e3:.2f} ms, kernels {busy_s * 1e3:.2f} ms "
        f"on the device = {busy_s / wall_s:.1%} busy, {1 - busy_s / wall_s:.1%} "
        f"idle; {busy_s / fit_s:.1%} of the median unprofiled fit "
        f"({fit_s * 1e3:.2f} ms)")
    kinds = {}
    for key, us, _ in kernels:
        name = key.lower()
        if "site_grams" in name:
            kind = "Gram kernel"
        elif any(w in name for w in ("potrf", "trsm", "syrk", "herk", "chol", "magma", "getrs", "trsv")):
            kind = "solver factor/triangular kernels"
        elif "gemm" in name or "sm90_xmma" in name or "cutlass" in name:
            kind = "matrix products (packing einsums, solver products)"
        else:
            kind = "elementwise, copies, reductions (mirror, unpack, l2, equilibrate)"
        kinds[kind] = kinds.get(kind, 0.0) + us
    for kind, us in sorted(kinds.items(), key=lambda k: -k[1]):
        log(f"  {us / 1e3:11.3f} ms  {us / 1e6 / max(busy_s, 1e-12):6.1%}  {kind}")
    for key, us, count in sorted(kernels, key=lambda k: -k[1])[:top]:
        log(f"  {us / 1e3:11.3f} ms  x{count:<5d} {key[:90]}")
    return wall_s, busy_s


def phase_times(torch, np, coords, forces, cmap, groups, spec, ops):
    from aggforce_torch import Trajectory
    from aggforce_torch.ops.gram import (
        design_rows,
        site_grams,
        site_grams_plain,
        workspace_shapes,
    )
    from aggforce_torch.qp.fusedfeat import fused_gb_linear_map

    traj = Trajectory(
        coords=torch.as_tensor(coords, device="cuda"),
        forces=torch.as_tensor(forces, device="cuda"),
    )
    fit_s = []
    for seed in range(5):
        t0 = time.perf_counter()
        tmap = fused_gb_linear_map(
            traj, cmap, kbt=KBT, spec=spec, constraints=set(groups),
            l2_regularization=L2, constraint_rng=np.random.default_rng(seed),
        )
        torch.cuda.synchronize()
        fit_s.append(time.perf_counter() - t0)
        del tmap
    fit_min, fit_med = min(fit_s), float(np.median(fit_s))
    log(f"steady-state fit (trajectory on the card): min {fit_min:.4f} s, "
        f"median {fit_med:.4f} s -> {N_FRAMES / fit_med:.1f} frames/s "
        f"(median), {N_FRAMES / fit_min:.1f} frames/s (min); all "
        f"{', '.join(f'{x:.4f}' for x in fit_s)} s")
    fit_breakdown(torch, lambda: fused_gb_linear_map(
        traj, cmap, kbt=KBT, spec=spec, constraints=set(groups),
        l2_regularization=L2, constraint_rng=np.random.default_rng(0),
    ), fit_med)

    args = (*ops, spec.n_basis, WIDTH, 1e-3)
    kernel_ms = cuda_ms(torch, lambda: site_grams(*args), reps=10)
    plain_ms = cuda_ms(torch, lambda: site_grams_plain(*args), reps=3)
    gpos, cg, fg, mask, centers_flat, kcounts = ops
    rows = design_rows(
        gpos, cg, fg, mask, centers_flat, kcounts, spec.n_basis, 1.0 / WIDTH,
        1e-3,
    )
    rows_t = rows.transpose(1, 2)
    library_ms = cuda_ms(torch, lambda: torch.bmm(rows_t, rows), reps=5)
    del rows, rows_t

    s_dim, t, g_pad = cg.shape[0], gpos.shape[1], gpos.shape[2]
    k_pad = g_pad * (1 + spec.n_basis)
    flops = 2.0 * 3 * t * s_dim * k_pad * (k_pad + 1) / 2
    n_bytes = 4.0 * (
        sum(x.numel() for x in ops) + s_dim * k_pad * k_pad
    )
    n_chunks = -(-t // workspace_shapes(t, s_dim, k_pad)[0])
    report = kernel_report(
        "site_grams", kernel_ms, stage_ms(torch, False, args, n_chunks),
        flops, n_bytes, library_ms, plain_ms,
    )
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return report


def sweep_fixture():
    """The JAX bench's sweep geometry (bench.py:415-530) from fixed seeds:
    1,500 atoms, 375 constraint pairs (G = 1,125 groups, G_pad = 1,136), a
    cg site on every 23rd atom (S = 66), 20,000 frames."""
    import numpy as np

    from aggforce_torch import LinearMap
    from aggforce_torch.utils.synth import synthesize_trajectory

    base = np.random.default_rng(0).normal(scale=1.5, size=(SWEEP_ATOMS, 3))
    groups = [frozenset((i, i + 1)) for i in range(0, SWEEP_ATOMS // 2, 2)]
    cmap = LinearMap(
        [[i] for i in range(0, SWEEP_ATOMS, SWEEP_ATOMS // 64)], n_fg_sites=SWEEP_ATOMS
    )
    coords, forces = synthesize_trajectory(
        base, groups, SWEEP_FRAMES, seed=1, motion_scale=0.02
    )
    return coords, forces, cmap, groups


def raw_params(ops):
    """Flat-parameter Gram operands in the tiled kernel's form: the raw
    (n_basis,) centers and the (G_pad,) per-group weights."""
    gpos, cg, fg, mask, centers_flat, kcounts_flat = ops
    g_pad = gpos.shape[2]
    return (
        gpos, cg, fg, mask, centers_flat[::g_pad].contiguous(),
        kcounts_flat[:g_pad].contiguous(),
    )


def compare_tiled(torch, args, n_basis, label):
    """The tiled kernel's raw (S, n_pairs, G_pad, G_pad) tiles against its
    plain version: atol 3e-4 * (max|plain| + 1), the bound of
    tests/test_pallas_gram.py:144-168."""
    from aggforce_torch.ops.gram import site_grams_tiled_blocks, site_grams_tiled_plain

    got = site_grams_tiled_blocks(*args, n_basis, WIDTH, 1e-3)
    torch.cuda.synchronize()
    ref = site_grams_tiled_plain(*args, n_basis, WIDTH, 1e-3)
    err = float((got - ref).abs().max())
    atol = 3e-4 * (float(ref.abs().max()) + 1.0)
    finite = bool(torch.isfinite(got).all())
    log(f"site_grams_tiled vs plain [{label}] tiles={tuple(got.shape)} "
        f"max_abs_err={err:.6g} atol={atol:.6g} finite={finite}")
    del got, ref
    if not finite or not err <= atol:
        fail(f"site_grams_tiled disagrees with its plain version at {label}")
    return err


def tiled_error_vs_float64(torch, args, n_basis):
    """Gate the tiled kernel's tiles of one site against the same arithmetic
    summed in float64, as ``gram_error_vs_float64`` does for the first
    kernel; a Gram without the divergence term must fail it."""
    from aggforce_torch.ops.gram import site_grams_tiled_blocks, site_grams_tiled_plain

    def no_divergence(gpos, cg, fg, mask, centers, kbt_counts, *rest):
        return site_grams_tiled_plain(
            gpos, cg, fg, mask, centers, torch.zeros_like(kbt_counts), *rest
        )

    exact = site_grams_tiled_plain(*(x.double() for x in args), n_basis, WIDTH, 1e-3)
    peak = float(exact.abs().max())
    rel = {}
    for name, fn in (
        ("kernel", site_grams_tiled_blocks),
        ("plain", site_grams_tiled_plain),
        ("planted fault: no divergence term", no_divergence),
    ):
        err = float((fn(*args, n_basis, WIDTH, 1e-3).double() - exact).abs().max())
        rel[name] = err / peak
        log(f"{name} tiled Gram of one site at sweep width vs float64 sum: max "
            f"abs err / max entry = {err / peak:.3e} (limit {GRAM_REL_LIMIT:.0e})")
    del exact
    if not rel["kernel"] <= GRAM_REL_LIMIT:
        fail("the tiled kernel's Gram is further than the limit from a float64 sum")
    if not rel["planted fault: no divergence term"] > GRAM_REL_LIMIT:
        fail("the tiled Gram check does not reject a Gram without the divergence term")


def sweep_operands(torch, np, coords, forces, cmap, groups, spec, sites):
    """The tiled kernel's operands for ``sites`` exactly as the sweep path
    packs them (coords/forces already on the card)."""
    from aggforce_torch.ops.gram import pack_operands
    from aggforce_torch.qp.fusedfeat import group_factorization

    geom = group_factorization(cmap, spec, set(groups))

    def dev(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device="cuda")

    mask = torch.ones(coords.shape[0], dtype=torch.float32, device="cuda")
    ops = pack_operands(
        coords, forces, mask, dev(cmap.standard_matrix[sites]),
        dev(geom["group_mean"]), dev(geom["onehot"]), dev(geom["counts"]),
        SWEEP_KBT, spec.n_basis, dev(geom["centers"]),
    )
    gpos, cg, fg, centers_flat, kcounts = ops
    return raw_params((gpos, cg, fg, mask, centers_flat, kcounts))


def phase_sweep_kernels(torch, block_args, n_basis):
    errs = [compare_tiled(
        torch, block_args, n_basis,
        f"sweep width, one block of {block_args[1].shape[0]} sites, T={SWEEP_FRAMES}",
    )]
    gpos, cg, *rest = block_args
    tiled_error_vs_float64(torch, (gpos, cg[:1].contiguous(), *rest), n_basis)
    for i, (g, t, s, nb) in enumerate(
        [(5, 37, 1, 4), (1125, 83, 2, 2), (17, 1007, 3, 7), (16, 16, 1, 1), (145, 333, 2, 7)]
    ):
        edge = raw_params(random_operands(torch, g, t, s, nb, seed=200 + i))
        label = f"G_pad={edge[0].shape[2]} T={t} S={s} n_basis={nb} masked"
        errs.append(compare_tiled(torch, edge, nb, label))
    return max(errs)


def sweep_block_gate(torch, np, coords, forces, cmap, groups, spec, coefs):
    """The sweep fit's first site block against a float64 witness solved on
    the card, as ``fit_checks`` does at config #3: the fit's objective gap
    must be <= J_GAP_LIMIT, and a fit on a Gram without the divergence term
    (solved in float64, so that the fault and not a failed solve is seen)
    must not pass. The Gram, the constraint rows and the witness are all
    float64, through the fit's own assembly with the plain tiled Gram."""
    from aggforce_torch.ops.eqp import batched_eqp_solve_shared
    from aggforce_torch.qp.fusedfeat import _fit_parts, _gram_function, group_factorization

    block = np.arange(SWEEP_SITE_BLOCK)
    geom = group_factorization(cmap, spec, set(groups))
    frame_idx = np.random.default_rng(3).choice(SWEEP_FRAMES, size=20, replace=False)

    def dev(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float64, device="cuda")

    xyz, frc = coords.double(), forces.double()
    cmap64 = dev(cmap.standard_matrix)
    plain = _gram_function(False, torch.device("cuda"), 1024, tiled=True)

    def no_divergence(gpos, cg, fg, mask, centers, kbt_counts, *rest):
        return plain(gpos, cg, fg, mask, centers, torch.zeros_like(kbt_counts), *rest)

    def problem(gram_fn):
        return _fit_parts(
            xyz, frc, torch.ones(SWEEP_FRAMES, dtype=torch.float64, device="cuda"),
            xyz[torch.as_tensor(frame_idx, device="cuda")], cmap64,
            dev(geom["group_mean"]), dev(geom["onehot"]), dev(geom["counts"]),
            dev(geom["centers"]), SWEEP_KBT, L2, spec, gram_fn, tiled=True,
            cmap_rows=cmap64[block], site_sel=dev(np.eye(cmap.n_cg_sites)[block]),
        )

    def solve(gram, target):
        return batched_eqp_solve_shared(
            gram, rows[None], target[None, ..., None], delta=1e-12, iters=40
        )[0, ..., 0]

    gram_fault = problem(no_divergence)[0]
    gram, rows, b = problem(plain)
    log("  float64 Grams and constraint rows assembled")
    c_fault = solve(gram_fault, b)
    del gram_fault
    log("  planted fault solved in float64")
    norm = torch.linalg.norm(rows, dim=2)

    def objective(c):
        return float(torch.einsum("si,sij,sj->", c, gram, c))

    coefs = {
        "sweep fit, block 0 (main path)": dev(coefs[block]),
        "planted fault: no divergence term, float64 solve": c_fault,
    }
    gaps = {}
    for name, c in coefs.items():
        target = torch.einsum("smn,sn->sm", rows, c)
        witness = solve(gram, target)
        gaps[name] = (objective(c) - objective(witness)) / objective(witness)
        viol = float(((target - b) / norm).abs().max())
        wviol = float(((torch.einsum("smn,sn->sm", rows, witness) - target) / norm).abs().max())
        log(f"  {name}: objective gap to its float64 witness {gaps[name]:+.3e} "
            f"(limit {J_GAP_LIMIT:.0e}); constraint violation {viol:.2e}; "
            f"witness meets the fit's constraint values to {wviol:.2e}")
    del gram, rows, b
    failed = []
    if not gaps["sweep fit, block 0 (main path)"] <= J_GAP_LIMIT:
        failed.append("the sweep fit's first block misses its float64 witness")
    if not gaps["planted fault: no divergence term, float64 solve"] > J_GAP_LIMIT:
        failed.append("the sweep objective gate does not reject the planted fault")
    if failed:
        fail("; ".join(failed))


def phase_sweep_fit(torch, np, traj, cmap, groups, spec):
    """The sweep path end to end: the first fit gates the launch count and
    finite forces, a second fit gives the steady-state time, a third runs
    under the profiler."""
    from aggforce_torch.ops.gram import site_grams, site_grams_tiled
    from aggforce_torch.qp import fused_gb_linear_map_blocked

    def fit():
        return fused_gb_linear_map_blocked(
            traj, cmap, kbt=SWEEP_KBT, spec=spec, constraints=set(groups),
            l2_regularization=L2, n_constraint_frames=20,
            constraint_rng=np.random.default_rng(3), chunk_size=256,
            site_block=SWEEP_SITE_BLOCK,
        )

    n_blocks = -(-cmap.n_cg_sites // SWEEP_SITE_BLOCK)
    torch.cuda.reset_peak_memory_stats()
    site_grams.launches = site_grams_tiled.launches = 0
    t0 = time.perf_counter()
    tmap = fit()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = site_grams_tiled.launches
    peak_bytes = torch.cuda.max_memory_allocated()
    tags = tmap.force_map.tags
    log(f"sweep fit ({cmap.n_cg_sites} sites, K_exp={tags['coef_list'][0].size}, "
        f"T={SWEEP_FRAMES}, site_block={SWEEP_SITE_BLOCK}): first fit "
        f"{first_s:.3f} s; site_grams_tiled "
        f"launches {launches} (blocks {n_blocks}), site_grams launches "
        f"{site_grams.launches}; solver_resid {tags['solver_resid']:.3e}; "
        f"escalated sites {tags['escalated']} in "
        f"{tags['escalation_seconds']:.3f} s; peak device memory "
        f"{peak_bytes / 2**30:.2f} GiB")
    if launches != n_blocks:
        fail(f"the sweep fit launched site_grams_tiled {launches} times, not {n_blocks}")
    if not peak_bytes <= SWEEP_PEAK_LIMIT_GIB * 2**30:
        fail(f"the sweep fit's peak device memory {peak_bytes / 2**30:.2f} GiB is "
             f"above {SWEEP_PEAK_LIMIT_GIB} GiB")
    coords8 = traj.coords[:8].cpu().numpy()
    forces8 = traj.forces[:8].cpu().numpy()
    mapped = np.asarray(tmap.map_arrays(coords8, forces8)[1])
    log(f"sweep mapped forces of 8 frames: shape {mapped.shape} finite="
        f"{bool(np.isfinite(mapped).all())} mean|f| {np.abs(mapped).mean():.6g}")
    if mapped.shape != (8, cmap.n_cg_sites, 3) or not np.isfinite(mapped).all():
        fail("the sweep fit's mapped forces are not finite or have the wrong shape")
    if not tags["solver_resid"] <= 1e-4:
        fail(f"sweep solver residual {tags['solver_resid']} above 1e-4")
    del tmap
    t0 = time.perf_counter()
    tmap = fit()
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t0
    log(f"sweep fit, second: {second_s:.3f} s -> {SWEEP_FRAMES / second_s:.1f} "
        f"frames/s; first {first_s:.3f} s -> {SWEEP_FRAMES / first_s:.1f} frames/s")
    fit_breakdown(torch, fit, second_s, top=15)
    return tmap, launches, first_s, second_s, peak_bytes


def sweep_kernel_times(torch, args, n_basis):
    """The tiled kernel per launch at the sweep block's shapes, its plain
    version, and one torch.bmm of the block's materialized design rows (the
    library yardstick: the full square, without the row build)."""
    from aggforce_torch.ops.gram import (
        PRODUCT_TILE,
        block_pairs,
        design_rows,
        site_grams_tiled_blocks,
        site_grams_tiled_plain,
        workspace_shapes,
    )

    kargs = (*args, n_basis, WIDTH, 1e-3)
    kernel_ms = cuda_ms(torch, lambda: site_grams_tiled_blocks(*kargs), reps=2)
    plain_ms = cuda_ms(torch, lambda: site_grams_tiled_plain(*kargs), reps=1)
    gpos, cg, fg, mask, centers, kbt_counts = args
    s_dim, t, g_pad = cg.shape[0], gpos.shape[1], gpos.shape[2]
    k_pad = g_pad * (1 + n_basis)
    rows = torch.empty((s_dim, 3 * t, k_pad), dtype=torch.float32, device="cuda")
    for s in range(s_dim):
        rows[s] = design_rows(
            gpos, cg[s:s + 1], fg, mask, centers.repeat_interleave(g_pad),
            kbt_counts.repeat(n_basis), n_basis, 1.0 / WIDTH, 1e-3,
        )[0]
    rows_t = rows.transpose(1, 2)
    library_ms = cuda_ms(torch, lambda: torch.bmm(rows_t, rows), reps=1)
    one_site_bmm_ms = cuda_ms(torch, lambda: torch.bmm(rows_t[:1], rows[:1]), reps=2)
    del rows, rows_t

    flops = 2.0 * 3 * t * s_dim * k_pad * (k_pad + 1) / 2
    pairs = block_pairs(n_basis)
    n_bytes = 4.0 * (
        sum(x.numel() for x in args) + s_dim * len(pairs) * g_pad * g_pad
    )
    log(f"site_grams_tiled ({s_dim} sites): torch.bmm of one site's 2.2 GB rows "
        f"{one_site_bmm_ms:.3f} ms")
    tc, scratch_shape, running_shape = workspace_shapes(t, s_dim, k_pad)
    n_chunks = -(-t // tc)
    report = kernel_report(
        "site_grams_tiled", kernel_ms,
        stage_ms(torch, True, kargs, n_chunks), flops,
        n_bytes, library_ms, plain_ms,
    )
    # what the two stages move: the build writes each chunk's K-major rows
    # once; each 128x128 product tile reads one or two 128-column panels of
    # them (from L2 or device memory)
    n_tiles = -(-k_pad // PRODUCT_TILE)
    n_upper = n_tiles * (n_tiles + 1) // 2
    written = 4.0 * n_chunks * scratch_shape[0] * scratch_shape[1] * scratch_shape[2]
    panels = 4.0 * n_chunks * s_dim * (2 * n_upper - n_tiles) * PRODUCT_TILE * 3 * tc
    log(f"site_grams_tiled workspace: frame chunk {tc} ({n_chunks} chunks), row "
        f"scratch {4.0 * scratch_shape[0] * scratch_shape[1] * scratch_shape[2] / 2**20:.1f} "
        f"MiB, fp64 running tiles {8.0 * running_shape[0] * running_shape[1] * running_shape[2] / 2**20:.1f} "
        f"MiB; rows written {written:.4g} B, panel reads {panels:.4g} B "
        f"({n_upper * s_dim} tiles per chunk)")
    return report


def phase_sweep(torch, np, smi):
    from aggforce_torch import Trajectory
    from aggforce_torch.qp.fusedfeat import GBFeatSpec

    t0 = time.perf_counter()
    coords_np, forces_np, cmap, groups = sweep_fixture()
    coords = torch.as_tensor(coords_np, device="cuda")
    forces = torch.as_tensor(forces_np, device="cuda")
    del coords_np, forces_np
    spec = GBFeatSpec(outer=8.0, inner=0.0, n_basis=7, width=1.0)
    log(f"sweep fixture: {tuple(coords.shape)} frames x atoms x 3, "
        f"{cmap.n_cg_sites} cg sites, {time.perf_counter() - t0:.3f} s")
    block_args = sweep_operands(
        torch, np, coords, forces, cmap, groups, spec, np.arange(SWEEP_SITE_BLOCK)
    )
    max_err = phase_sweep_kernels(torch, block_args, spec.n_basis)
    traj = Trajectory(coords=coords, forces=forces)
    tmap, launches, first_s, second_s, peak_bytes = phase_sweep_fit(
        torch, np, traj, cmap, groups, spec
    )
    log("sweep fit, first site block against a float64 witness on the card:")
    sweep_block_gate(
        torch, np, coords, forces, cmap, groups, spec,
        np.stack(tmap.force_map.tags["coef_list"]),
    )
    times = sweep_kernel_times(torch, block_args, spec.n_basis)
    log(f"sweep phase {time.perf_counter() - t0:.3f} s; sweep fit peak device "
        f"memory {peak_bytes / 2**30:.2f} GiB; {SWEEP_FRAMES / second_s:.1f} "
        f"frames/s ({smi})")
    return launches, max_err, times


def main() -> int:
    import numpy as np
    import torch

    smi = phase_environment(torch)
    phase_build()
    from aggforce_torch.qp.fusedfeat import GBFeatSpec

    coords, forces, cmap, groups = fixture()
    spec = GBFeatSpec(outer=OUTER, n_basis=N_BASIS, width=WIDTH)
    ops, max_err = phase_kernels(torch, coords, forces, cmap, groups, spec)
    spec, launches, first_fit_s, peak_bytes = phase_main_path(
        torch, np, coords, forces, cmap, groups
    )
    log(f"first fit {first_fit_s:.3f} s; peak device memory of the main path "
        f"{peak_bytes / 2**20:.1f} MiB ({smi})")
    times = phase_times(torch, np, coords, forces, cmap, groups, spec, ops)
    del ops
    tiled_launches, tiled_err, tiled_times = phase_sweep(torch, np, smi)
    kernels = [
        {
            "name": "site_grams",
            "route": "cuda",
            "source": "aggforce_torch/csrc/site_grams.cu",
            "replaces": "aggforce_tpu/ops/pallas_gram.py:36",
            "launches": launches,
            "max_abs_err": max_err,
            **times,
        },
        {
            "name": "site_grams_tiled",
            "route": "cuda",
            "source": "aggforce_torch/csrc/site_grams_tiled.cu",
            "replaces": "aggforce_tpu/ops/pallas_gram.py:313",
            "launches": tiled_launches,
            "max_abs_err": tiled_err,
            **tiled_times,
        },
    ]
    log(f"process seconds {time.perf_counter() - _T_START:.3f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
