#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when it
fails:

1. environment: torch/CUDA versions, the card's name and power limit, TF32;
2. build: compile every CUDA kernel of the path from ``aggforce_torch/csrc``;
3. each kernel against its plain torch version on the card, at the main
   path's shapes (kernel 1 also at the config-#4 fold shape, 2,000 frames)
   and at edge shapes, and the config-#3 Gram against a float64 sum of the
   same rows; then (3b) constraint detection's kernel (csrc/pair_moments.cu)
   against the plain ``_distance_sd`` on the same centred card tensors, at
   config #1's 10,000 frames x 175 atoms (within one system and against 40
   shifted atoms) and at 256 frames of 1,500 and 3,000 atoms: every pair's
   sd^2 within a derived fp32-summation limit (a plain path that leaves out
   a frame must not be), the mask thresholded and holding the system's
   pairs, the same bits twice; its and the plain path's times and bound;
4. the main path: ``aggforce_torch.project_forces`` with the featurized
   method on a 10,000-frame synthetic trajectory at the full width of
   config #3 (175 atoms, 30 constraint pairs, 10 cg sites, n_basis=7):
   the kernel must have launched, the mapped forces must be finite and the
   constraints met; the kernel fit's and the plain fit's objectives must
   lie near float64 witnesses (see ``fit_checks``), and so must the
   site-blocked fit (``site_block=3``, a ragged last block); a small input
   holds the kernel fit, the plain fit and the blocked fit to
   2e-3 * mean|f| of each other. A planted fault (a Gram without the
   divergence term) must fail the Gram and the objective gates. The fit's
   map applies through the apply kernel (csrc/gb_apply.cu), once per
   4,096-frame chunk of numpy frames and once per call of card tensors,
   within a derived fp32 bound of the float64 formula (the formula without
   its divergence term must not be) and of the plain ``_fused_apply`` on
   the card, the same bits twice; its and the plain path's times and bound;
5. times: first fit, steady-state fits and a profiled fit's device time by
   kernel, each kernel (and its build and product stages) against its plain
   version, its library yardstick and two bounds (3xTF32 on the tensor
   cores, the route it takes, and fp32 on the CUDA cores), peak device
   memory; kernel 1 also at the fold shape, and its float64 Gram (the CV's)
   there and at the edge shapes against its plain version summed in float64;
   (a) config #4, ``fused_gb_cv`` at the shape of bench.py's run_cv (phase
   4's fixture, 5 folds, l2 1e0 to 1e5, 20 constraint frames): five kernel-1
   launches per CV; every cell, and each l2's score, within 1e-7 plus
   cond * 2**-50 of a float64 witness solved on the card apart from the
   program, on the CV's own float64 fold Grams; the
   refit of (fold 0, l2 1e3) scored by force_smoothness within 2e-3 of its
   cell, and a CV on fold Grams without the divergence term outside it;
   times, frames/s, a profiled CV and a solve block's peak memory;
   (b) ``project_forces_grid_cv(fast=True)``: a (featurizer x l2) grid must
   equal ``fused_gb_cv_grid``'s table and launch kernel 1 five times per
   featurizer; the linear grid at config #1 must lie within 1e-4 of float64
   scores and launch no Gram kernel; each grid's detection launches the
   detection kernel once;
   (c) ``fused_gb_linear_map_batch`` at config #3, 4 windows of 64 seeds: one
   kernel-1 launch per window, every fit finite, the first and last seed
   of each window within 1e-4 of its float64 optimum; ms per fit and
   pipelined frames/s; two seeds refitted singly are printed beside theirs;
6. the sweep path: ``fused_gb_linear_map_blocked`` at the full sweep width
   (1,500 atoms, 375 constraint pairs, 66 cg sites, n_basis=7, so
   K_exp = 9,000; 20,000 frames; 6 sites per block, 11 blocks). The tiled
   kernel against its plain version at sweep width and at edge shapes, and
   against a float64 sum (the planted fault must fail); the fit must launch
   the tiled kernel once per block and map to finite forces; its first
   block must lie near a float64 witness solved on the card (the planted
   fault must not), and its peak device memory must stay within 24 GiB;
   its map through the apply kernel as in phase 4, on a 2,048-frame slice
   and on the whole 20,000-frame window in one call, which may add to the
   card's peak memory no more than its workspace (about 1.2 GB); then the fit's times and profile, and
   the tiled kernel's times;
7. the linear path, which runs no Gram kernel (both launch counts must
   read 0 after each of its runs, detection's kernel must have launched
   once per detection, and ``qplinear.fit_routes`` must show one device fit
   and no escalation per fit):
   (a) config #1: ``aggforce_torch.project_forces`` with every default
   (``qp_linear_map``, ``constrained_inds="auto"``) on phase 4's fixture on
   the card. The detected pairs must be the 30 synthesized, |M F^T - I|
   <= 1e-4, constrained pairs must share their columns of F, and the
   mapped forces must lie within 3e-6 relative RMS of the float64 host fit
   (a fit without constraints, the planted fault, must not). The same
   holds for float64 forces, which must take the device route, and with
   TF32 switched on for the process, which the fit must leave on; with TF32
   on, a config-#3 fit (also held to the objective gate), a ``FusedGBMap``
   and a ``TLinearMap`` application and a CV cell must read what they read
   with TF32 off, and the fit with its full-fp32 scopes bypassed must not;
   ``constraint_aware_uni_map`` through ``project_forces`` must map to the
   sums of each site's atoms and their partners; then detection and five
   steady-state fits are timed;
   (b) the linear sweep (bench.py:310-412, nothing cut): 100,000 frames x
   3,000 atoms made on the card, detection on 256 frames must find the 750
   pairs, two ``qp_linear_map`` fits, a profiled fit, the Gram against its
   fp32 bound (over its unique entries), and the mapped forces of 4,096
   frames within 1e-5 relative RMS of a float64 witness built apart from
   the program's Gram and solver (the planted fault must not be);
8. config #2, the Gaussian noised maps (bench.py:711-781, nothing cut; run
   between 7a and 7b), on phase 4's fixture as CUDA tensors, var 0.002,
   which runs no hand-written kernel (both launch counts must read 0):
   ``joptgauss_map`` (a first fit, five seeds, two applications that stay
   on the card), ``stagedjoptgauss_map`` on its fused and piecewise paths,
   ``stagedjforcegauss_map``, ``stagedjslicegauss_map`` and
   ``project_forces(method=joptgauss_map)``. Gates: (1) |M F^T - I| <=
   1e-4 and shared columns for the pairs; (2) mapped forces within 1e-5
   relative RMS of a float64 witness solved apart from the program on the
   same augmented arrays (a fit without constraints must miss it); (3) the
   fused staged fit takes the draw of the piecewise one, and its maps and
   mapped coordinates agree with them (2e-4, 2e-3, 1e-5); (4) the force
   variant's noise contribution <= 1e-6; (5) MSCG projections of the two
   optimized maps correlate above 0.9 and differ below 0.1 (a map with
   M F^T = 1.5 I must fail); (6) with TF32 on, a fit reads the same bits;
   (7) no Gram kernel launches. Then times, a profiled fit and peak memory;
9. one JSON line listing every kernel, printed after phase 15 (detection's
   launches counted on the paths of phases 5b, 7, 8, 10 and 12, not on the
   mesh and examples; the apply kernel's on phase 4's fit and, as 0, on
   those linear paths);
   the last line is the result;
10. the generic featurizer path at config #3 width on 2,000 frames (cut
   from 10,000: it holds each site's (T, N, K_exp) features on the host, as
   the reference does): ``qp_feat_linear_map(allow_fused=False)`` with the
   device and the host backends, each within 1e-4 of the float64 optimum
   for the constraint values it meets (a Gram without the divergence term
   must not be), no Gram kernel launch, the map's application equal to the
   FusedGBMap of its coefficients, and gb_feat's "reorder" and "basic"
   divergences against the closed form on 64 frames (every cg atom
   constrained to a partner);
11. the streamed featurized fit (``fused_gb_linear_map_streamed``) at
   config #3 width over 100,000 frames read from .npy files in 4,096-frame
   chunks: kernel 1 launched once per chunk; the streamed Gram within 1e-5
   of the largest entry of the in-memory kernel Gram and of a float64 sum
   (a stream that skips a chunk must not be); the fit within 1e-4 of its
   float64 optimum; kernel 1 against its plain version at the chunk shapes;
   the fit's time against its transfers at the pinned copy rate and its
   kernel launches, and a profiled fit;
12. the streamed linear fit (``qp_linear_map_streamed``) at the linear sweep
   width over 20,000 frames from .npy files: within 5e-5 of the in-memory
   map, mapped forces of 4,096 frames within 1e-5 relative RMS of the
   float64 witness (a fit without constraints must not be), no kernel;
13. ``stage_trajectory`` of phase 4's fixture (float32 bit-exact, float16
   within 2e-3 of each value), ``save_tmap``/``load_tmap`` of a config-#3
   FusedGBMap and a config-#1 map (the same forces to 1e-6), and the first
   config-#3 fit in two fresh processes building the kernels from scratch,
   without and with ``warm_featurized_fit`` overlapping a 2 s sleep.

14. the mesh (``aggforce_torch.parallel``): (a) on a world-size-1 NCCL
   group in this process (``initialize_distributed()`` with no cluster),
   every mesh entry point at its config's width: config #1 and the config-#3
   fit through ``project_forces(mesh=)``, the batch fits, the config-#4 CV,
   ``stagedjoptgauss_map``, both streamed fits, ``warm_featurized_fit`` and
   the sweep fit, each equal bit for bit to its single-device result and
   launching the kernels as that path does; (b) two ranks sharing the card
   over gloo (``--mesh-child`` subprocesses on a FileStore): the config-#3
   fit (5,000 frames per rank, kernel 1 once on each), the batch fits, the
   linear CV at config #1 and the config-#4 CV, config #1, the dense
   ``sharded_linear_fit``, the streamed featurized fit on each rank's
   ``process_frame_slice`` and the sweep fit (kernel 2 on each rank's
   blocks). Gates: the ranks' results equal bit for bit; the reduced Gram
   within 1e-5 of the largest entry of the single-device kernel Gram (rank
   0's share alone must not be); the config-#3 fit, two batch fits and one
   sweep block per rank within 1e-4 of their float64 optimum; config #1's
   mapped forces within 3e-6 relative RMS of the float64 host fit; the CV
   cells through phase 5's gate on its reduced fold Grams. Each fit's time, peak memory and
   all-reduces (bytes, seconds) per rank are printed; two ranks on one card
   show correctness and the collectives' cost, not scaling. Then kernel 1
   at the per-rank shard shape.

15. the example twins (``examples/torch_*.py``), each loaded by path and
   driven through its ``main`` on the card at the JAX examples' sizes:
   ``torch_gauss`` (2,000 frames; no kernel; its linear residual within
   1e-5 of the float64 witness's of phase 7b, which a fit without
   constraints must miss; the staged map's matrices after save/load),
   ``torch_production_fit`` (2,000 frames; kernel 1 once for the warm-up,
   once for the fit and once per 512-frame chunk; the fit and the streamed
   fit within 1e-4 of their float64 optimum; the map after save/load
   within 1e-6; then once more as a fresh process), ``torch_bootstrap``
   (32 maps in windows of 16, kernel 1 once per window, every fit finite
   with its solver residual within 1e-4; on the synthetic dimer and on
   phase 4's fixture as ``--data``, K_exp = 1,050, where the kernel's Gram
   lies within 1e-6 of a float64 sum; the fits' distance to their float64
   optimum is printed: l2 = 1e1 is below the solver's fixed ridge there)
   and ``torch_cv_feat --quick`` (2,000 frames, 5 folds; the grid
   cut to 2 featurizers x 2 l2 values, their width not cut; kernel 1 once
   per fold of each featurizer and once for the refit; the 30 pairs
   detected; its scores equal to a direct ``fused_gb_cv_grid`` bit for bit;
   the refit of the best point within phase 5's limit, 1e-4 + cond *
   2**-24, of the float64 optimum of the problem its solver poses). Each
   gate has a planted fault that must fail. Then kernel 1 against its
   plain version and timed at each shape the examples gave it.

``python3 chip_smoke.py --warmup-child with|without BUILD_DIR`` is phase
13's subprocess and ``python3 chip_smoke.py --mesh-child RANK WORLD STORE``
phase 14's, not entry points.

The fixtures are the JAX bench's standalone geometry (bench.py:290-307),
its CV and batch shapes (bench.py:783-820, 887-927),
its featurized sweep geometry (bench.py:415-530) and its linear sweep
geometry (bench.py:310-412), made from fixed seeds; nothing is read from
outside the repository.
"""

import json
import subprocess
import sys
import time
import types
import warnings

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
# a Gram kernel's timing: device milliseconds it runs first, so the card's
# clocks have left their idle state (a phase that waits on the host leaves
# the card idle), and the rounds of launch time and stage probe that
# alternate after that
WARM_MS = 300.0
TIMING_ROUNDS = 3
# the linear path: orthogonality |M F^T - I|; config #1's mapped forces
# against the float64 host fit, relative RMS (tests/test_golden.py:62); the
# linear sweep's (bench.py:310-412) against its float64 witness on the first
# SWEEP_CHECK_FRAMES frames (the BASELINE.json north star)
ORTHO_LIMIT = 1e-4
CONFIG1_REL_RMS_LIMIT = 3e-6
LINEAR_SWEEP_FRAMES = 100_000
LINEAR_SWEEP_ATOMS = 3_000
SWEEP_CHECK_FRAMES = 4_096
SWEEP_REL_RMS_LIMIT = 1e-5
# frames per block of the sweep witness's float64 Gram: not the program's
# block, and not a divisor of the frame count
WITNESS_BLOCK = 3_000
# config #4, the featurized CV at the shape of bench.py's run_cv
# (bench.py:783-820): phase 4's fixture, 5 folds, six l2 values, 20
# constraint frames per fold, folds and samples from one seed
CV_L2S = [1e0, 1e1, 1e2, 1e3, 1e4, 1e5]
CV_FOLDS = 5
CV_SEED = 11
# a linear CV's score against float64 scores, relative; the refit of one
# featurized CV cell, scored by force_smoothness of its mapped holdout
# forces, against the cell (tests/test_cv_fast.py:118)
CV_REL_LIMIT = 1e-4
# a featurized CV cell against its float64 witness on the same float64 fold
# Grams, relative. The CV solves each (l2, fold, site) problem in float64
# (LU of the equilibrated KKT matrix, four refinements), so the two differ
# by float64 rounding, about cond * 2**-52 with cond the largest over the
# cell's sites; the limit is CV_F64_REL_LIMIT plus 4x that. A solve that
# took back the float32 solver's ridge (1e-6 of the mean diagonal) moves
# the scores far more at the small l2 values (6e-3 at l2 = 1, 2e-5 at 1e2,
# 7e-6 at 1e3 on the tests' 40-atom system).
CV_F64_REL_LIMIT = 1e-7
F64_EPS = 2.0**-50
# the float32 device solver's ridge on the normalized Gram
SOLVER_DELTA = 1e-6
F32_EPS = 2.0**-24
REFIT_REL_LIMIT = 2e-3
# the batch fits of config #3's bench (bench.py:887-927): 4 windows of 64 seeds
BATCH_WINDOWS, BATCH_WINDOW = 4, 64
# a path's outputs with TF32 on for the process against TF32 off, largest
# difference over largest entry: a TF32 product is good to ~1e-3
TF32_REL_LIMIT = 1e-6
# config #2, the Gaussian noised maps (bench.py:711-781): phase 4's fixture,
# var 0.002. The augmented fit's mapped forces against a float64 witness,
# relative RMS (the BASELINE.json north star); the fused staged fits against
# the piecewise ones (tests/test_gaussmap.py:245-258): premap and second
# stage maps within 2e-4 and 2e-3 of the largest entry, mapped coordinates
# within 1e-5; the force variant's noise contribution (its own
# contribution_tolerance); MSCG projections of two optimized maps
# (tests/test_gaussmap.py:168-219): correlation and relative difference
GAUSS_VAR = 0.002
GAUSS_SEEDS = range(100, 105)
GAUSS_REL_RMS_LIMIT = 1e-5
STAGED_PRE_TOL, STAGED_POST_TOL, STAGED_COORD_TOL = 2e-4, 2e-3, 1e-5
REMAINING_LIMIT = 1e-6
MSCG_SAMPLES, MSCG_TIMED_SAMPLES = 200, 1_000
MSCG_CORR_LIMIT, MSCG_REL_LIMIT = 0.9, 0.1
MSCG_FIELDS = dict(inner=0.2, outer=1.2, width=0.5)
# the generic featurizer path at config #3 width: 2,000 frames, not 10,000,
# because it holds each site's (T, N, K_exp) features on the host, as the
# reference does (1.6 GB per site here, 8.1 GB at 10,000 frames); gb_feat's
# autodiff divergences against the closed form on 64 frames
# (tests/test_featlinear.py:98)
GENERIC_FRAMES = 2_000
DIV_FRAMES = 64
DIV_ATOL, DIV_RTOL = 2e-4, 1e-3
# a generic map's application against the FusedGBMap of its coefficients,
# largest difference over largest entry
GENERIC_APPLY_LIMIT = 1e-4
# the streamed featurized fit: config #3 width, 100,000 frames in .npy files,
# 4,096-frame chunks; its Gram against the in-memory kernel Gram and a
# float64 sum of the same frames, relative to the largest entry
STREAM_FRAMES = 100_000
STREAM_CHUNK = 4_096
STREAM_GRAM_LIMIT = 1e-5
# the streamed linear fit at the linear sweep width over 20,000 frames
# (.npy files): its map against the in-memory fit's (tests/test_stream.py:46)
LINEAR_STREAM_FRAMES = 20_000
LINEAR_STREAM_ATOL = 5e-5
# staging: the float16 wire's error relative to each value (floor 1e-3;
# tests/test_staging.py:40); maps after save_tmap/load_tmap against the
# maps saved, largest difference over largest entry
STAGE_F16_LIMIT = 2e-3
SERIALIZE_REL_LIMIT = 1e-6
# the host sleep that stands in for loading in the warm-up subprocesses
WARMUP_SLEEP_S = 2.0
# phase 14, the mesh: two ranks (processes) sharing the card over gloo, each
# with half of config #3's frames; the reduced Gram against the
# single-device kernel Gram, relative to its largest entry (a Gram missing a
# rank's share lands near 1); the batch fits' windows of 64 seeds; how long
# a child may run
MESH_WORLD = 2
MESH_GRAM_LIMIT = 1e-5
MESH_BATCH_WINDOWS = 2
MESH_CHILD_TIMEOUT_S = 600
# constraint detection's kernel (csrc/pair_moments.cu): the flops its bound
# counts per (frame, pair) item (three differences, three products or FMAs,
# a square root, the fluctuation and two moment sums), the bytes of its
# outputs per pair (the fp64 sd and the mask), its threshold, and how often
# it and the plain _distance_sd are run per timing
DETECT_FLOPS_PER_ITEM = 10
DETECT_OUT_BYTES = 9
DETECT_THRESHOLD = 1e-3
DETECT_REPS, DETECT_PLAIN_REPS = 50, 5
# detection's launches of csrc/pair_moments.cu per driven path, filled by
# read_counts and phase_cv_grids for the kernels line
DETECT_LAUNCHES = {}
# the featurized apply's kernel (csrc/gb_apply.cu): fp32 operations per
# (frame, site, group, basis) term (the offset and its square, expf's
# range reduction and polynomial, the clip rule, the derivative, two FMAs),
# the card's ex2 rate (MUFU, 16 per SM and clock on 132 SMs at the 1.98 GHz
# boost clock), the timing repetitions, what a call may add to the card's
# peak memory beyond its workspace (``gb_apply.workspace_bytes``; the
# allocator rounds its four blocks to 2 MiB), and its launches and reports
# per driven path
APPLY_FLOPS_PER_TERM = 20
PEAK_EX2_PER_S = 16 * 132 * 1.98e9
APPLY_REPS = 20
APPLY_SLACK_BYTES = 4 * (2 << 20)
APPLY_LAUNCHES = {}
APPLY_REPORTS = {}


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


def fixture_geometry():
    """Config #3's system (bench.py:290-307): base coordinates of 175 atoms,
    30 constraint pairs, a cg site every 18th atom."""
    import numpy as np

    from aggforce_torch import LinearMap

    rng = np.random.default_rng(0)
    n_sites = 175
    base = rng.normal(scale=0.5, size=(n_sites, 3))
    groups = [frozenset((i, i + 1)) for i in range(0, 60, 2)]
    cmap = LinearMap([[i] for i in range(0, n_sites, 18)], n_fg_sites=n_sites)
    return base, groups, cmap


def fixture():
    from aggforce_torch.utils.synth import synthesize_trajectory

    base, groups, cmap = fixture_geometry()
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


def cv_folds(np):
    """The config-#4 CV's folds, as ``fused_gb_cv`` draws them first from
    ``np.random.default_rng(CV_SEED)``."""
    from aggforce_torch.qp.cv import _fold_segments

    return _fold_segments(N_FRAMES, CV_FOLDS, np.random.default_rng(CV_SEED))


def phase_kernels(torch, np, coords, forces, cmap, groups, spec):
    ops = packed_operands(torch, coords, forces, cmap, groups, spec)
    errs = [compare_kernel(torch, ops, spec.n_basis, f"config #3, T={N_FRAMES}")]
    gram_error_vs_float64(ops, spec.n_basis)
    fold = cv_folds(np)[0]
    fold_ops = packed_operands(torch, coords[fold], forces[fold], cmap, groups, spec)
    errs.append(compare_kernel(
        torch, fold_ops, spec.n_basis, f"config #4 CV fold, T={len(fold)}"
    ))
    compare_kernel_f64(
        torch, fold_ops, spec.n_basis, f"config #4 CV fold, T={len(fold)}", timed=True
    )
    for i, (g, t, s, nb) in enumerate(
        [(5, 37, 1, 4), (17, 1007, 3, 7), (145, 333, 2, 7), (16, 16, 1, 1)]
    ):
        edge = random_operands(torch, g, t, s, nb, seed=100 + i)
        label = f"G_pad={edge[0].shape[2]} T={t} S={s} n_basis={nb} masked"
        errs.append(compare_kernel(torch, edge, nb, label))
        compare_kernel_f64(torch, edge, nb, label)
    return ops, fold_ops, max(errs)


def compare_kernel_f64(torch, ops, n_basis, label, timed=False):
    """Kernel 1's float64 Gram (the CV's fold Grams) against its plain
    version summed in float64: within GRAM_REL_LIMIT of the largest entry
    (the two build the float32 rows by different float32 operations),
    exactly symmetric, and its diagonal's mean relative bias printed beside
    the 3xTF32 kernel's (which reads a positive sum low). With ``timed``
    both kernels' times. Returns the error."""
    from aggforce_torch.ops.gram import site_grams, site_grams_plain

    args = (*ops, n_basis, WIDTH, 1e-3)
    got = site_grams(*args, out_dtype=torch.float64)
    want = site_grams_plain(*args, out_dtype=torch.float64)
    tf32 = site_grams(*args).double()
    torch.cuda.synchronize()
    err = float((got - want).abs().max() / want.abs().max())
    diag = torch.diagonal(want, dim1=1, dim2=2)
    live = diag > 1e-9 * diag.max()

    def bias(x):
        return float(((torch.diagonal(x, dim1=1, dim2=2) - diag)[live] / diag[live]).mean())

    log(f"site_grams float64 vs plain float64 [{label}]: max abs err / max entry "
        f"{err:.3e} (limit {GRAM_REL_LIMIT:.0e}); diagonal's mean relative bias "
        f"{bias(got):+.2e} (3xTF32 kernel {bias(tf32):+.2e})")
    if not err <= GRAM_REL_LIMIT:
        fail(f"site_grams float64 disagrees with its plain version at {label}")
    if not torch.equal(got, got.transpose(1, 2)):
        fail(f"site_grams float64 is not symmetric at {label}")
    if timed:
        f64_ms = cuda_ms(torch, lambda: site_grams(*args, out_dtype=torch.float64), reps=5)
        tf32_ms = cuda_ms(torch, lambda: site_grams(*args), reps=5)
        s_dim, t, k_pad = ops[1].shape[0], ops[0].shape[1], ops[0].shape[2] * (1 + n_basis)
        flops = 3.0 * t * s_dim * k_pad * (k_pad + 1)
        log(f"site_grams float64 [{label}]: {f64_ms:.3f} ms per launch "
            f"({flops / f64_ms / 1e9:.2f} TFLOP/s of unique padded entries), 3xTF32 "
            f"{tf32_ms:.3f} ms")
    return err


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


def warm_card(torch, fn, min_ms=WARM_MS):
    """Run ``fn`` until at least ``min_ms`` of device time has passed."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    while True:
        fn()
        stop.record()
        stop.synchronize()
        if start.elapsed_time(stop) >= min_ms:
            return


def launch_and_stage_ms(torch, tiled, fn, args, reps, n_chunks):
    """Device milliseconds of one launch of a Gram kernel (``fn``, the mean
    of ``reps`` calls) and of its stages, the row build
    (``site_grams_build``) and the tensor-core product
    (``site_grams_product``), each launched once per frame chunk and timed by
    CUDA events that the C entry records between the launches
    (``ops.gram.stage_times``). After ``warm_card``, TIMING_ROUNDS rounds
    each time the launch and then probe its stages, so both see the same
    clocks; returns the median launch time and the stages of the probe with
    the median sum, which ``kernel_report`` holds to it."""
    from statistics import median

    from aggforce_torch.ops.gram import stage_times

    warm_card(torch, fn)
    launches, probes = [], []
    for _ in range(TIMING_ROUNDS):
        launches.append(cuda_ms(torch, fn, reps))
        torch.cuda.synchronize()
        probes.append(stage_times(tiled, *args))
    ms = median(launches)
    build, product = sorted(probes, key=sum)[len(probes) // 2]
    log(f"{TIMING_ROUNDS} rounds after {WARM_MS:.0f} ms of warm-up: launch "
        f"{', '.join(f'{x:.3f}' for x in launches)} ms (mean of {reps}); stages of "
        f"one launch ({n_chunks} chunks, CUDA events between the launches) "
        f"{', '.join(f'{b:.3f} + {p:.3f}' for b, p in probes)} ms (build + product)")
    return ms, {"build": build, "product": product}


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
        f"entries ({TF32_PASSES * flops / ms / 1e9:.2f} TFLOP/s of TF32 products)")
    if stages is not None:
        log(f"{name}: build stage {stages['build']:.3f} ms, product stage "
            f"{stages['product']:.3f} ms "
            f"({TF32_PASSES * flops / stages['product'] / 1e9:.2f} TFLOP/s TF32)")
        staged = stages["build"] + stages["product"]
        if not abs(staged - ms) <= 0.05 * ms:
            fail(f"{name}: the stages add up to {staged:.3f} ms, not within 5% of the "
                 f"launch's {ms:.3f} ms")
    log(f"{name}: bound {bound_ms:.4g} ms ({bound_by}; {TF32_PASSES}x{flops:.4g} "
        f"TF32 FLOP at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s, {n_bytes:.4g} B at "
        f"{PEAK_BYTES / 1e12:.2f} TB/s), fp32 CUDA-core bound {fp32_ms:.4g} ms; "
        f"{ms / bound_ms:.2f}x the bound; plain {plain_ms:.3f} ms; torch.bmm "
        f"yardstick {library_ms:.3f} ms, which the kernel "
        f"{'beats' if ms < library_ms else 'does NOT beat'} ({library_ms / ms:.2f}x)")
    report = dict(
        ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
        bound_by=bound_by, fp32_bound_ms=fp32_ms,
    )
    if stages is not None:
        report.update(build_ms=stages["build"], product_ms=stages["product"])
    return report


def detection_inputs(torch, np, coords, groups):
    """The detection kernel's cases: (label, xyz, other or None, the pairs
    detection must find), each centred per frame on the card as
    ``guess_pairwise_constraints`` centres it. Config #1's 10,000 frames x
    175 atoms within one system and against a rigidly shifted copy of atoms
    100-139 (each copy bound to its twin and to the twin's partners), the
    featurized sweep geometry (1,500 atoms, 375 pairs) and the linear sweep
    (3,000 atoms, 750 pairs) on 256 frames, as phase 7b detects."""
    from aggforce_torch.constraints import finder
    from aggforce_torch.utils.synth import synthesize_trajectory_device

    def centred(xyz, other=None):
        xyz = torch.as_tensor(xyz, device="cuda")
        centroid = torch.mean(xyz, dim=1, keepdim=True)
        x = finder._centered(xyz, centroid, xyz.device).contiguous()
        if other is None:
            return x, None
        return x, finder._centered(other, centroid, xyz.device).contiguous()

    def sweep_geometry(n):
        base = np.random.default_rng(0).normal(scale=1.5, size=(n, 3))
        pairs = [frozenset((i, i + 1)) for i in range(0, n // 2, 2)]
        xyz, _ = synthesize_trajectory_device(
            base, pairs, 256, seed=1, motion_scale=0.02, device="cuda"
        )
        return centred(xyz), set(pairs)

    xyz = torch.as_tensor(coords, device="cuda")
    shift = torch.tensor([0.3, 0.0, 0.0], dtype=xyz.dtype, device="cuda")
    across = {
        (k, j) for k in range(40) for j in range(xyz.shape[1])
        if j == 100 + k or frozenset((100 + k, j)) in groups
    }
    cases = [
        (f"config #1, T={xyz.shape[0]}, 175 sites", *centred(xyz), set(groups)),
        (f"config #1 across, T={xyz.shape[0]}, 175 x 40 sites",
         *centred(xyz, xyz[:, 100:140] + shift), across),
    ]
    for n in (SWEEP_ATOMS, LINEAR_SWEEP_ATOMS):
        (x, other), pairs = sweep_geometry(n)
        cases.append((f"sweep geometry, T=256, {n} sites", x, other, pairs))
    return cases


def detection_limit(torch, finder, x, src, chunk):
    """Per pair, how far the kernel's sd^2 may lie from the plain path's.

    Both take the same fp32 distances (up to one rounding of the sum of
    squares, which the kernel takes with FMAs) and differ in how they add
    the moments: the plain path in fp32 chunk sums of ``chunk`` frames
    added chunk by chunk, the kernel in fp64. A chain of m fp32 additions
    of terms of size up to s is off by at most m u s, so with the mean
    square fluctuation ms = s2 / T each of s2 / T and mean^2 is off by at
    most m u ms, m = chunk + ceil(T / chunk) + 2; the distances' rounding
    adds 4 u dmax |delta| to each delta squared. Hence
    |sd_k^2 - sd_p^2| <= 3 m u ms + 8 u dmax sqrt(ms).
    """
    t = x.shape[0]
    d0 = finder._dists(x[:1], src[:1])[0]
    ms = torch.zeros(d0.shape, dtype=torch.float64, device=x.device)
    dmax = 0.0
    for lo in range(0, t, chunk):
        d = finder._dists(x[lo : lo + chunk], src[lo : lo + chunk])
        dmax = max(dmax, float(d.max()))
        delta = (d - d0).double()
        ms += (delta * delta).sum(dim=0)
    ms /= t
    m = chunk + -(-t // chunk) + 2
    return 3 * m * F32_EPS * ms + 8 * F32_EPS * dmax * ms.sqrt()


def phase_detection(torch, np, coords, groups, smi):
    """Constraint detection's kernel, ``finder.pair_moments``
    (csrc/pair_moments.cu), against the plain ``_distance_sd`` on the same
    card tensors at each case of ``detection_inputs``. Gates: every pair's
    sd^2 within ``detection_limit`` of the plain path's (a plain path that
    leaves out the last frame, the planted fault, must not be); the mask is
    sd < threshold, self pairs cleared, and holds the case's pairs; a second
    call gives the same bits. Then the kernel's and the plain path's device
    times against the kernel's bound. Returns the kernels line's fields."""
    from aggforce_torch.constraints import finder

    t_phase = time.perf_counter()
    lib = finder._pair_moments_lib()
    reports = {}
    for label, x, other, pairs in detection_inputs(torch, np, coords, groups):
        within = other is None
        src = x if within else other
        t, n_a, n_b = x.shape[0], x.shape[1], src.shape[1]
        chunk = finder._chunk_length(t, n_a, n_b)
        with torch.cuda.device(x.device):
            n_slices = lib.aggforce_pair_moments_slices(t, n_a, n_b, int(within))
        sd_k, hits = finder.pair_moments(x, other, DETECT_THRESHOLD)
        sd_again, hits_again = finder.pair_moments(x, other, DETECT_THRESHOLD)
        limit = detection_limit(torch, finder, x, src, chunk)

        def gap_of_limit(sd_p):
            gap = (sd_k.square() - sd_p.double().square()).abs()
            return float((gap / limit.clamp_min(1e-300)).max())

        worst = gap_of_limit(finder._distance_sd(x, src, chunk))
        fault = gap_of_limit(finder._distance_sd(x[:-1], src[:-1], chunk))
        expect = sd_k < DETECT_THRESHOLD
        if within:
            expect.fill_diagonal_(False)
        ii, jj = np.nonzero(hits.cpu().numpy())
        found = (
            {frozenset(p) for p in zip(ii.tolist(), jj.tolist())} if within
            else set(zip(ii.tolist(), jj.tolist()))
        )
        bitwise = torch.equal(sd_k.view(torch.int64), sd_again.view(torch.int64)) and (
            torch.equal(hits, hits_again)
        )
        log(f"detection kernel, {label} (F = {n_slices} frame slices): sd^2 off the "
            f"plain path's by at most {worst:.3g} of its limit (must be <= 1), the "
            f"planted fault (last frame left out) by {fault:.3g} (must exceed 1); "
            f"{len(found)} pairs, equal to the {len(pairs)} expected: {found == pairs}; "
            f"a second call the same bits: {bitwise}")
        if not worst <= 1.0:
            fail(f"detection kernel, {label}: sd off the plain path beyond its limit")
        if not fault > 1.0:
            fail(f"detection kernel, {label}: the sd gate does not reject the planted fault")
        if not torch.equal(hits, expect) or found != pairs:
            fail(f"detection kernel, {label}: the mask is not sd < threshold or misses pairs")
        if not bitwise:
            fail(f"detection kernel, {label}: two calls gave different bits")

        def kernel():
            return finder.pair_moments(x, other, DETECT_THRESHOLD)

        warm_card(torch, kernel)
        ms = cuda_ms(torch, kernel, DETECT_REPS)
        plain_ms = cuda_ms(torch, lambda: finder._distance_sd(x, src, chunk), DETECT_PLAIN_REPS)
        pairs_computed = n_a * (n_a - 1) // 2 if within else n_a * n_b
        flops = DETECT_FLOPS_PER_ITEM * t * pairs_computed
        n_bytes = 4 * 3 * t * (n_a if within else n_a + n_b) + DETECT_OUT_BYTES * n_a * n_b
        flops_ms, bytes_ms = flops / PEAK_FP32_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
        bound_ms = max(flops_ms, bytes_ms)
        bound_by = "operations" if flops_ms >= bytes_ms else "bytes"
        log(f"detection kernel, {label}: {ms:.4f} ms per call (both launches), plain "
            f"_distance_sd {plain_ms:.3f} ms ({plain_ms / ms:.1f}x); bound {bound_ms:.4g} ms "
            f"({bound_by}; {flops:.4g} FLOP at {PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s fp32, "
            f"{n_bytes:.4g} B at {PEAK_BYTES / 1e12:.2f} TB/s), {ms / bound_ms:.1f}x the "
            f"bound ({smi})")
        reports[label] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            slices=n_slices, max_gap_of_limit=worst,
        )
    log(f"phase 3b (detection kernel) {time.perf_counter() - t_phase:.1f} s")
    cell, *rest = reports
    return {
        **reports[cell],
        "max_gap_of_limit": max(r["max_gap_of_limit"] for r in reports.values()),
        "at_shapes": {label: reports[label] for label in rest},
    }


def apply_kernel_report(torch, label, fmap, coords, forces, check_frames, plain_step, smi):
    """The featurized apply's kernel (``ops.gb_apply``, csrc/gb_apply.cu)
    through ``fmap`` (a fitted ``FusedGBMap`` on the card) at one shape.
    Gates: one launch per call of card tensors; the same bits twice; the
    first ``check_frames`` frames within the derived fp32 bound of the
    float64 formula (``gb_apply_witness``; the formula without its
    divergence term, the planted fault, must not be) and within the plain
    path's limit of ``_fused_apply`` on the card (that bound plus the
    witness's bound for the plain path's fp32 geometry plus n u of the
    terms' magnitudes for its n-term fp32 sums). Then its and the
    plain path's device times (the plain one in ``plain_step``-frame calls,
    as the benchmark's entries slice a sweep window), the bound (fp32
    operations at 67 TFLOP/s or ex2 at the MUFU rate, or the bytes) and what
    the call added to the card's peak memory. Returns the report."""
    from aggforce_torch.ops.gb_apply import gb_apply, gb_apply_witness
    from aggforce_torch.qp.fusedfeat import _fused_apply, exact_centers

    t, n_atoms = forces.shape[0], forces.shape[1]
    s_dim, n_groups = fmap._cmap_mat.shape[0], fmap._onehot.shape[1]
    n_basis = fmap._spec.n_basis
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = gb_apply.launches
    out = fmap(forces, coords)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    again = fmap(forces, coords)
    launches = gb_apply.launches - before
    bitwise = torch.equal(out.view(torch.int32), again.view(torch.int32))
    del again

    def plain(hi):
        return torch.cat([
            _fused_apply(
                forces[lo : min(lo + plain_step, hi)], coords[lo : min(lo + plain_step, hi)],
                fmap._coefs, fmap._cmap_mat, fmap._group_mean, fmap._onehot,
                fmap._counts, fmap._centers, fmap._kbt, fmap._spec,
            )
            for lo in range(0, hi, plain_step)
        ])

    consts = (
        fmap._coefs, fmap._cmap_mat, fmap._onehot, fmap._counts,
        exact_centers(fmap._host_geometry[1], fmap._spec),
    )
    chunk = 32 if n_groups > 500 else 256
    x, f = coords[:check_frames], forces[:check_frames]
    value, bound, _ = gb_apply_witness(f, x, *consts, fmap._kbt, fmap._spec, chunk)
    _, plain_bound, scale = gb_apply_witness(
        f, x, *consts, fmap._kbt, fmap._spec, chunk, fp32_geometry=True
    )
    fault, _, _ = gb_apply_witness(f, x, *consts, 0.0, fmap._spec, chunk)
    head = out[:check_frames].double()
    worst = float(((head - value).abs() / bound).max())
    fault_worst = float(((fault - value).abs() / bound).max())
    plain_limit = bound + plain_bound + 2.0 * (
        n_atoms + n_groups * (n_basis + 1)
    ) * F32_EPS * scale
    plain_head = plain(check_frames).double()
    plain_worst = float(((head - plain_head).abs() / plain_limit).max())
    rms = float(value.square().mean().sqrt())
    err = float((head - value).abs().max()) / rms
    plain_err = float((plain_head - value).abs().max()) / rms
    del value, bound, plain_bound, scale, fault, head, plain_head
    log(f"apply kernel, {label}: {launches} launches for 2 calls (must read 2); the "
        f"same bits twice: {bitwise}; first {check_frames} frames off the float64 "
        f"formula by at most {worst:.3g} of the derived bound (must be <= 1), the "
        f"planted fault (no divergence term) by {fault_worst:.3g} (must exceed 1); off "
        f"the plain path by {plain_worst:.3g} of its limit (must be <= 1); largest "
        f"error over the rms force: kernel {err:.3g}, plain {plain_err:.3g}")
    failed = []
    if launches != 2:
        failed.append(f"{launches} launches for two calls")
    if not bitwise:
        failed.append("two calls gave different bits")
    if not worst <= 1.0:
        failed.append("off the float64 formula beyond its bound")
    if not fault_worst > 1.0:
        failed.append("the bound does not reject the planted fault")
    if not plain_worst <= 1.0:
        failed.append("off the plain path beyond its limit")
    if failed:
        fail(f"apply kernel, {label}: " + "; ".join(failed))

    def kernel():
        return fmap(forces, coords)

    warm_card(torch, kernel)
    ms = cuda_ms(torch, kernel, APPLY_REPS)
    plain_ms = cuda_ms(torch, lambda: plain(t), 1)
    terms = t * s_dim * n_groups * n_basis
    ops_ms = APPLY_FLOPS_PER_TERM * terms / PEAK_FP32_FLOPS * 1e3
    ex2_ms = terms / PEAK_EX2_PER_S * 1e3
    n_bytes = 4 * (2 * t * n_atoms * 3 + t * s_dim * 3)
    bytes_ms = n_bytes / PEAK_BYTES * 1e3
    bound_ms = max(ops_ms, ex2_ms, bytes_ms)
    bound_by = "operations" if bound_ms == ops_ms else "ex2" if bound_ms == ex2_ms else "bytes"
    log(f"apply kernel, {label}: {ms:.4f} ms per call (all three launches), plain "
        f"_fused_apply in {plain_step}-frame calls {plain_ms:.3f} ms ({plain_ms / ms:.1f}x); "
        f"bound {bound_ms:.4g} ms ({bound_by}: {terms:.4g} terms, "
        f"{APPLY_FLOPS_PER_TERM} fp32 FLOP each at {PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s "
        f"{ops_ms:.4g} ms, one ex2 each {ex2_ms:.4g} ms, {n_bytes:.4g} B {bytes_ms:.4g} "
        f"ms), {ms / bound_ms:.2f}x the bound; the call added {peak / 2**20:.1f} MiB to "
        f"the card's peak ({smi})")
    report = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        peak_added_bytes=peak, max_gap_of_bound=worst, max_gap_of_plain_limit=plain_worst,
        max_err_over_rms=err, plain_max_err_over_rms=plain_err,
    )
    APPLY_REPORTS[label] = report
    return report


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


def fit_problem(torch, np, coords, forces, cmap, groups, spec, dtype, gram_fn, seed=7, l2=L2):
    """The main path's per-site QP on the card, (Gram + l2, constraint rows,
    targets), built by the fit's own assembly in ``dtype`` with ``gram_fn``
    on the 20 constraint frames that ``fused_gb_linear_map`` draws from
    ``constraint_rng=np.random.default_rng(seed)``."""
    from aggforce_torch.qp.fusedfeat import _fit_parts, group_factorization

    geom = group_factorization(cmap, spec, set(groups))
    frame_idx = np.random.default_rng(seed).choice(len(coords), size=20, replace=False)

    def dev(x):
        if isinstance(x, torch.Tensor):
            return x.to(dtype=dtype)
        return torch.as_tensor(np.asarray(x), dtype=dtype, device="cuda")

    xyz = dev(coords)
    return _fit_parts(
        xyz, dev(forces), torch.ones(len(coords), dtype=dtype, device="cuda"),
        xyz[torch.as_tensor(frame_idx, device="cuda")], dev(cmap.standard_matrix),
        dev(geom["group_mean"]), dev(geom["onehot"]), dev(geom["counts"]),
        dev(geom["centers"]), KBT, l2, spec, gram_fn,
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
    return gram, rows


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


def phase_main_path(torch, np, coords, forces, cmap, groups, smi):
    import aggforce_torch
    from aggforce_torch import Curry, Multifeaturize, gb_feat, id_feat
    from aggforce_torch import Trajectory
    from aggforce_torch.ops.gb_apply import gb_apply
    from aggforce_torch.ops.gram import site_grams, site_grams_tiled
    from aggforce_torch.qp import fused_gb_linear_map_blocked, qp_feat_linear_map
    from aggforce_torch.qp.fusedfeat import recognize_canonical_featurizer

    featurizer = Multifeaturize(
        [id_feat, Curry(gb_feat, outer=OUTER, n_basis=N_BASIS, width=WIDTH)]
    )
    torch.cuda.reset_peak_memory_stats()
    site_grams.launches = site_grams_tiled.launches = gb_apply.launches = 0
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
    # numpy frames go to the card in chunks of FusedGBMap._APPLY_CHUNK
    read_applies("config #3 fit (project_forces, numpy frames)", -(-N_FRAMES // 4096))

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
    problem64 = fit_checks(
        torch, np, coords, forces, cmap, groups, spec, tmap, plain_map, blocked_map
    )
    small_input_parity(np)
    apply_kernel_report(
        torch, "config #3 (10,000 frames, S 10, G 145)", tmap.force_map,
        torch.as_tensor(coords, device="cuda"), torch.as_tensor(forces, device="cuda"),
        1024, 4096, smi,
    )
    return spec, launches, first_fit_s, peak_bytes, problem64


def featurized_kind(name):
    """The kind of a kernel of the featurized fits, by its name."""
    if "site_grams" in name:
        return "Gram kernel"
    if any(w in name for w in ("potrf", "trsm", "syrk", "herk", "chol", "magma", "getrs", "trsv")):
        return "solver factor/triangular kernels"
    if "gemm" in name or "sm90_xmma" in name or "cutlass" in name:
        return "matrix products (packing einsums, solver products)"
    return "elementwise, copies, reductions (mirror, unpack, l2, equilibrate)"


def fit_breakdown(torch, fit, fit_s, top=12, kind_of=featurized_kind):
    """One steady-state fit under torch.profiler: device time by kernel, the
    kernels' total against the profiled fit's own wall clock (the device's
    idle share) and against the unprofiled fit time ``fit_s``, and the
    device time by kind of kernel (``kind_of`` maps a lowercase kernel name
    to its kind). Returns (wall s, busy s, {kind: device s})."""
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
        kind = kind_of(key.lower())
        kinds[kind] = kinds.get(kind, 0.0) + us
    for kind, us in sorted(kinds.items(), key=lambda k: -k[1]):
        log(f"  {us / 1e3:11.3f} ms  {us / 1e6 / max(busy_s, 1e-12):6.1%}  {kind}")
    for key, us, count in sorted(kernels, key=lambda k: -k[1])[:top]:
        log(f"  {us / 1e3:11.3f} ms  x{count:<5d} {key[:90]}")
    return wall_s, busy_s, {kind: us / 1e6 for kind, us in kinds.items()}


def phase_times(torch, np, coords, forces, cmap, groups, spec, ops):
    from aggforce_torch import Trajectory
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
    report = gram_kernel_times(torch, ops, spec.n_basis, "site_grams")
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return report, fit_med


def real_groups(kbt_counts):
    """G, the groups of the Gram: the kernels pad the group axis to G_pad
    with groups of weight 0, a choice of theirs that adds no work to the
    function, so bounds and the library call count only the G real ones."""
    return int((kbt_counts != 0).sum())


def real_columns(rows, n_basis, g):
    """Design rows (S, 3T, (1 + n_basis) * G_pad) cut to their
    (1 + n_basis) * G real columns (``design_rows`` lays them out as
    1 + n_basis blocks of G_pad), contiguous."""
    s_dim, n_rows, k_pad = rows.shape
    blocks = rows.view(s_dim, n_rows, 1 + n_basis, k_pad // (1 + n_basis))
    return blocks[..., :g].reshape(s_dim, n_rows, (1 + n_basis) * g)


def gram_kernel_times(torch, ops, n_basis, name, stages=True):
    """Kernel 1 on the operands ``ops`` (as ``packed_operands`` returns
    them): its time, its plain version's, ``torch.bmm`` of the materialized
    rows, its stages and its bounds (``kernel_report``). With ``stages``
    False the launch time is the median of TIMING_ROUNDS means after
    ``warm_card``, without the stage probe (whose events would weigh on a
    launch of tens of microseconds)."""
    from aggforce_torch.ops.gram import (
        design_rows,
        site_grams,
        site_grams_plain,
        workspace_shapes,
    )

    args = (*ops, n_basis, WIDTH, 1e-3)
    plain_ms = cuda_ms(torch, lambda: site_grams_plain(*args), reps=3)
    gpos, cg, fg, mask, centers_flat, kcounts = ops
    s_dim, t, g_pad = cg.shape[0], gpos.shape[1], gpos.shape[2]
    g = real_groups(kcounts[:g_pad])
    k_pad, k_exp = g_pad * (1 + n_basis), g * (1 + n_basis)
    rows = real_columns(design_rows(
        gpos, cg, fg, mask, centers_flat, kcounts, n_basis, 1.0 / WIDTH, 1e-3,
    ), n_basis, g)
    rows_t = rows.transpose(1, 2)
    library_ms = cuda_ms(torch, lambda: torch.bmm(rows_t, rows), reps=5)
    del rows, rows_t

    flops = 2.0 * 3 * t * s_dim * k_exp * (k_exp + 1) / 2
    n_bytes = 4.0 * (
        2 * 3 * t * g + cg.numel() + mask.numel() + 2 * k_exp + s_dim * k_exp * k_exp
    )
    n_chunks = -(-t // workspace_shapes(t, s_dim, k_pad)[0])
    if stages:
        kernel_ms, stages = launch_and_stage_ms(
            torch, False, lambda: site_grams(*args), args, 10, n_chunks
        )
    else:
        from statistics import median

        warm_card(torch, lambda: site_grams(*args))
        rounds = [cuda_ms(torch, lambda: site_grams(*args), 20) for _ in range(TIMING_ROUNDS)]
        kernel_ms, stages = median(rounds), None
        log(f"{TIMING_ROUNDS} rounds after {WARM_MS:.0f} ms of warm-up: launch "
            f"{', '.join(f'{x:.4f}' for x in rounds)} ms (mean of 20)")
    return kernel_report(name, kernel_ms, stages, flops, n_bytes, library_ms, plain_ms)


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


def sweep_block_gate(torch, np, coords, forces, cmap, groups, spec, coefs, first_site=0):
    """A site block of the sweep fit (by default the first) against a
    float64 witness solved on the card, as ``fit_checks`` does at config #3:
    the fit's objective gap must be <= J_GAP_LIMIT, and a fit on a Gram
    without the divergence term (solved in float64, so that the fault and
    not a failed solve is seen) must not pass. The Gram, the constraint rows
    and the witness are all float64, through the fit's own assembly with the
    plain tiled Gram."""
    from aggforce_torch.ops.eqp import batched_eqp_solve_shared
    from aggforce_torch.qp.fusedfeat import _fit_parts, _gram_function, group_factorization

    block = np.arange(first_site, first_site + SWEEP_SITE_BLOCK)
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

    name_fit = f"sweep fit, sites {block[0]}-{block[-1]}"
    coefs = {
        name_fit: dev(coefs[block]),
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
    if not gaps[name_fit] <= J_GAP_LIMIT:
        failed.append(f"the {name_fit} miss their float64 witness")
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
    plain_ms = cuda_ms(torch, lambda: site_grams_tiled_plain(*kargs), reps=1)
    gpos, cg, fg, mask, centers, kbt_counts = args
    s_dim, t, g_pad = cg.shape[0], gpos.shape[1], gpos.shape[2]
    g = real_groups(kbt_counts)
    k_pad, k_exp = g_pad * (1 + n_basis), g * (1 + n_basis)
    rows = torch.empty((s_dim, 3 * t, k_exp), dtype=torch.float32, device="cuda")
    for s in range(s_dim):
        rows[s] = real_columns(design_rows(
            gpos, cg[s:s + 1], fg, mask, centers.repeat_interleave(g_pad),
            kbt_counts.repeat(n_basis), n_basis, 1.0 / WIDTH, 1e-3,
        ), n_basis, g)[0]
    rows_t = rows.transpose(1, 2)
    library_ms = cuda_ms(torch, lambda: torch.bmm(rows_t, rows), reps=1)
    one_site_bmm_ms = cuda_ms(torch, lambda: torch.bmm(rows_t[:1], rows[:1]), reps=2)
    del rows, rows_t

    flops = 2.0 * 3 * t * s_dim * k_exp * (k_exp + 1) / 2
    pairs = block_pairs(n_basis)
    n_bytes = 4.0 * (
        2 * 3 * t * g + cg.numel() + mask.numel() + n_basis + g
        + s_dim * len(pairs) * g * g
    )
    log(f"site_grams_tiled ({s_dim} sites): torch.bmm of one site's "
        f"{4.0 * 3 * t * k_exp / 1e9:.1f} GB rows "
        f"{one_site_bmm_ms:.3f} ms")
    tc, scratch_shape, running_shape = workspace_shapes(t, s_dim, k_pad)
    n_chunks = -(-t // tc)
    kernel_ms, stages = launch_and_stage_ms(
        torch, True, lambda: site_grams_tiled_blocks(*kargs), kargs, 2, n_chunks
    )
    report = kernel_report(
        "site_grams_tiled", kernel_ms, stages, flops, n_bytes, library_ms, plain_ms,
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
    from aggforce_torch.ops.gb_apply import workspace_bytes
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
    apply_kernel_report(
        torch, "sweep slice (2,048 frames, S 66, G 1,125)", tmap.force_map,
        coords[:2048], forces[:2048], 128, 2048, smi,
    )
    window = apply_kernel_report(
        torch, f"sweep window ({SWEEP_FRAMES} frames, S 66, G 1,125, one call)",
        tmap.force_map, coords, forces, 64, 2048, smi,
    )
    fmap = tmap.force_map
    # the call's float32 contiguous copy of an input that is not one already
    copies = sum(
        4 * x.numel() for x in (coords, forces)
        if x.dtype != torch.float32 or not x.is_contiguous()
    )
    ceiling = workspace_bytes(
        coords.shape[0], coords.shape[1], fmap._cmap_mat.shape[0], fmap._onehot.shape[1],
        fmap._spec.n_basis,
    ) + copies + APPLY_SLACK_BYTES
    log(f"sweep window apply: peak ceiling {ceiling / 2**20:.1f} MiB (workspace, "
        f"{copies / 2**20:.1f} MiB of input copies, allocator slack)")
    if not window["peak_added_bytes"] <= ceiling:
        fail(f"the sweep window's one apply call added {window['peak_added_bytes'] / 2**20:.0f} "
             f"MiB to the card's peak, above its ceiling of {ceiling / 2**20:.0f} MiB")
    times = sweep_kernel_times(torch, block_args, spec.n_basis)
    log(f"sweep phase {time.perf_counter() - t0:.3f} s; sweep fit peak device "
        f"memory {peak_bytes / 2**30:.2f} GiB; {SWEEP_FRAMES / second_s:.1f} "
        f"frames/s ({smi})")
    # phase 14 refits the sweep over the mesh: the trajectory stays on the card
    sweep = {
        "traj": traj, "cmap": cmap, "groups": groups, "spec": spec,
        "coefs": np.stack(tmap.force_map.tags["coef_list"]),
    }
    return launches, max_err, times, sweep


def linear_kind(name):
    """The kind of a kernel of the linear fit, by its name."""
    if "indexfunc" in name or "index_add" in name:
        return "reduced design rows (index_add_)"
    if any(w in name for w in ("potrf", "trsm", "syrk", "herk", "chol", "magma", "getrs", "trsv")):
        return "solver factor/triangular kernels"
    if "gemm" in name or "sm90_xmma" in name or "cutlass" in name:
        return "matrix products (the Gram's addmm, solver products)"
    return "elementwise, copies (block transposes), reductions"


def rel_rms(torch, got, ref):
    """RMS of ``got - ref`` relative to the RMS of ``ref``, in float64."""
    got, ref = torch.as_tensor(got).double(), torch.as_tensor(ref).double()
    return float(torch.sqrt(torch.mean((got - ref) ** 2) / torch.mean(ref**2)))


def reset_counts():
    """Every launch and route count to 0, just before a path is driven."""
    from aggforce_torch.constraints.finder import pair_moments
    from aggforce_torch.ops.gb_apply import gb_apply
    from aggforce_torch.ops.gram import site_grams, site_grams_tiled
    from aggforce_torch.qp.qplinear import fit_routes

    site_grams.launches = site_grams_tiled.launches = pair_moments.launches = 0
    gb_apply.launches = 0
    fit_routes.clear()


def read_applies(label, applies):
    """Fail unless the featurized apply's kernel (csrc/gb_apply.cu) launched
    ``applies`` times since the counts were reset (one launch per
    ``FusedGBMap`` call of card tensors, one per 4,096-frame chunk of numpy
    frames, none on a linear path); record the count under ``label``."""
    from aggforce_torch.ops.gb_apply import gb_apply

    APPLY_LAUNCHES[label] = gb_apply.launches
    log(f"{label}: gb_apply launches {gb_apply.launches} (must read {applies})")
    if gb_apply.launches != applies:
        fail(f"{label}: the apply kernel launched {gb_apply.launches} times, not {applies}")


def read_counts(label, detections, applies=0):
    """Log the counts a linear path left, and fail unless both Gram kernels'
    launch counts read 0 (the linear path runs no Gram kernel), the
    detection kernel's reads ``detections`` (one launch of
    csrc/pair_moments.cu per detection on the card) and the apply kernel's
    ``applies`` (``read_applies``); record the detections under ``label``
    and return the fit routes the path took."""
    from aggforce_torch.constraints.finder import pair_moments
    from aggforce_torch.ops.gram import site_grams, site_grams_tiled
    from aggforce_torch.qp.qplinear import fit_routes

    routes = dict(fit_routes)
    launched = site_grams.launches, site_grams_tiled.launches
    DETECT_LAUNCHES[label] = pair_moments.launches
    log(f"{label}: fit routes {routes}; site_grams launches {launched[0]}, "
        f"site_grams_tiled launches {launched[1]} (must read 0); pair_moments "
        f"launches {pair_moments.launches} (must read {detections})")
    if launched != (0, 0):
        fail(f"{label}: a Gram kernel launched on the linear path: {launched}")
    if pair_moments.launches != detections:
        fail(f"{label}: detection launched its kernel {pair_moments.launches} times, "
             f"not {detections}")
    read_applies(label, applies)
    return routes


def linear_map_gates(torch, np, tmap, cmap, constraints):
    """|M F^T - I| <= ORTHO_LIMIT, and equal columns of F for every
    constrained pair."""
    fmat = np.asarray(tmap.force_map.standard_matrix, dtype=np.float64)
    ortho = float(np.abs(cmap.standard_matrix @ fmat.T - np.eye(cmap.n_cg_sites)).max())
    tied = max((float(np.abs(fmat[:, i] - fmat[:, j]).max())
                for i, j in (sorted(p) for p in constraints)), default=0.0)
    log(f"  max |M F^T - I| = {ortho:.3e} (limit {ORTHO_LIMIT:.0e}); max |F[:, i] - "
        f"F[:, j]| over the {len(constraints)} constrained pairs = {tied:.3e}")
    if not ortho <= ORTHO_LIMIT:
        fail(f"the linear map misses orthogonality: |M F^T - I| = {ortho:.3e}")
    if tied != 0.0:
        fail("constrained pairs do not share their force-map columns")


def config1_float64_and_tf32(torch, np, coords, forces, cmap, groups, spec, host, fit):
    """Config #1 twice more with every default: float64 forces on the card
    must stay there (one device fit, no host fit), and with TF32 switched on
    for the process the detection and the fit must still meet their gates
    (and the switch be left on). Both are held to the float64 host fit.
    Then the featurized paths with TF32 on (``tf32_featurized_checks``)."""
    import aggforce_torch
    from aggforce_torch.qp import qplinear

    reset_counts()
    f64 = fit("auto", f=forces.double())
    routes = read_counts("config #1, float64 forces on the card", 1)
    err64 = rel_rms(torch, f64, host)
    log(f"  float64 forces: mapped forces rel RMS {err64:.3e} off the float64 host "
        f"fit (limit {CONFIG1_REL_RMS_LIMIT:.0e}), dtype {f64.dtype}, on {f64.device}")
    if routes != {"device": 1}:
        fail(f"config #1: float64 forces did not take the device route alone: {routes}")
    if not err64 <= CONFIG1_REL_RMS_LIMIT:
        fail("config #1: the float64 device fit misses the float64 host fit")

    matmul = torch.backends.cuda.matmul
    matmul.allow_tf32 = True
    try:
        reset_counts()
        res = aggforce_torch.project_forces(coords, forces, cmap)
        routes = read_counts("config #1 with TF32 on for the process", 1)
        still_on = matmul.allow_tf32
        # the same fit with the full-fp32 scope bypassed, to show what the
        # scope guards against (logged, not gated)
        labels_np, r = qplinear.constraint_labels(cmap.n_fg_sites, res["constraints"])
        unscoped, _ = qplinear._device_linear_fit.__wrapped__(
            forces,
            torch.as_tensor(labels_np, dtype=torch.int64, device="cuda"),
            torch.as_tensor(cmap.standard_matrix, dtype=torch.float32, device="cuda"),
            0.0,
            r,
        )
    finally:
        matmul.allow_tf32 = False
    err = rel_rms(torch, res["mapped_forces"], host)
    err_unscoped = rel_rms(torch, torch.einsum("sn,tnd->tsd", unscoped, forces), host)
    log(f"  TF32 on: {len(res['constraints'])} pairs detected (equal: "
        f"{res['constraints'] == set(groups)}), mapped forces rel RMS {err:.3e} "
        f"(limit {CONFIG1_REL_RMS_LIMIT:.0e}), switch still on after the fit: "
        f"{still_on}; the fit with its full-fp32 scope bypassed: {err_unscoped:.3e}")
    if res["constraints"] != set(groups):
        fail("config #1: with TF32 on, detection misses the synthesized pairs")
    if routes != {"device": 1}:
        fail(f"config #1: with TF32 on, the fit did not take the device route: {routes}")
    if not err <= CONFIG1_REL_RMS_LIMIT:
        fail("config #1: with TF32 on, the fit misses the float64 host fit")
    if not still_on:
        fail("config #1: the fit did not restore the process's TF32 switch")
    tf32_featurized_checks(torch, np, coords, forces, cmap, groups, spec)


def uniform_map_check(torch, np, coords, forces, cmap, groups):
    """``constraint_aware_uni_map`` through ``project_forces`` on the card
    tensors, constraints detected: each cg site sums the forces of its
    atoms and of their constraint partners, to 1e-6 relative RMS."""
    import aggforce_torch
    from aggforce_torch.qp import constraint_aware_uni_map

    reset_counts()
    res = aggforce_torch.project_forces(
        coords, forces, cmap, method=constraint_aware_uni_map
    )
    read_counts("config #1, constraint_aware_uni_map", 1)
    members = np.zeros(cmap.standard_matrix.shape)
    for s, row in enumerate(cmap.standard_matrix):
        sites = set(np.nonzero(row)[0].tolist())
        for pair in groups:
            if sites & pair:
                sites |= pair
        members[s, sorted(sites)] = 1.0
    expect = torch.einsum(
        "sn,tnd->tsd", torch.as_tensor(members, device="cuda"), forces.double()
    )
    got = res["mapped_forces"]
    err = rel_rms(torch, got, expect)
    log(f"  constraint_aware_uni_map: {int(members.sum())} fg sites aggregated by "
        f"{cmap.n_cg_sites} cg sites; mapped forces on {got.device}, rel RMS "
        f"{err:.3e} off the sums taken here (limit 1e-6)")
    if res["constraints"] != set(groups):
        fail("config #1: the uniform map's detection misses the synthesized pairs")
    if got.device.type != "cuda" or not err <= 1e-6:
        fail("config #1: the uniform map's mapped forces are wrong or off the card")


def phase_linear_config1(torch, np, coords_np, forces_np, cmap, groups, spec, smi):
    """Config #1 (bench.py:673-708) at the standalone width: project_forces
    with every default (qp_linear_map, constrained_inds="auto") on tensors
    on the card."""
    import aggforce_torch
    from aggforce_torch import Trajectory
    from aggforce_torch.qp import qp_linear_map

    coords = torch.as_tensor(coords_np, device="cuda")
    forces = torch.as_tensor(forces_np, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    result = aggforce_torch.project_forces(coords, forces, cmap)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    routes = read_counts("config #1, project_forces with every default", 1)
    found = result["constraints"]
    log(f"config #1: first project_forces {first_s:.3f} s (detection, fit and "
        f"mapping); {len(found)} pairs detected, equal to the "
        f"{len(groups)} synthesized: {found == set(groups)}")
    if found != set(groups):
        fail("config #1: the detected constraints are not the synthesized pairs")
    if routes != {"device": 1}:
        fail(f"config #1: the fit did not take the device route alone: {routes}")
    linear_map_gates(torch, np, result["tmap"], cmap, found)

    def fit(constraints, f=forces, **kw):
        return aggforce_torch.project_forces(
            coords, f, cmap, constrained_inds=constraints, **kw
        )["mapped_forces"]

    host = fit(found, solver_args={"backend": "host"})
    errs = {
        "device fit (main path)": rel_rms(torch, result["mapped_forces"], host),
        "planted fault: constrained_inds=set()": rel_rms(torch, fit(set()), host),
    }
    for name, err in errs.items():
        log(f"  {name} vs the float64 host fit: mapped forces rel RMS {err:.3e} "
            f"(limit {CONFIG1_REL_RMS_LIMIT:.0e})")
    if not errs["device fit (main path)"] <= CONFIG1_REL_RMS_LIMIT:
        fail("config #1: the device fit's mapped forces miss the float64 host fit")
    if not errs["planted fault: constrained_inds=set()"] > CONFIG1_REL_RMS_LIMIT:
        fail("config #1: the mapped-force gate does not reject the planted fault")

    config1_float64_and_tf32(torch, np, coords, forces, cmap, groups, spec, host, fit)
    uniform_map_check(torch, np, coords, forces, cmap, groups)

    traj = Trajectory(coords=coords, forces=forces)
    det_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        aggforce_torch.guess_pairwise_constraints(coords)
        det_s.append(time.perf_counter() - t0)
    fit_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        qp_linear_map(traj, cmap, constraints=found)
        torch.cuda.synchronize()
        fit_s.append(time.perf_counter() - t0)
    fit_min, fit_med = min(fit_s), float(np.median(fit_s))
    n_frames = coords.shape[0]
    log(f"config #1 steady-state qp_linear_map (trajectory on the card): min "
        f"{fit_min:.4f} s, median {fit_med:.4f} s -> {n_frames / fit_min:.1f} "
        f"frames/s (min), {n_frames / fit_med:.1f} frames/s (median); all "
        f"{', '.join(f'{x:.4f}' for x in fit_s)} s; detection "
        f"{min(det_s):.4f} s (min of 3); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB ({smi})")


def linear_sweep_fixture(torch, n_frames=LINEAR_SWEEP_FRAMES, seed=1):
    """The JAX bench's linear sweep (bench.py:310-412), nothing cut: 3,000
    atoms, 750 constraint pairs, a cg site every 46th atom (S = 66),
    ``n_frames`` (100,000) frames made on the card."""
    import numpy as np

    from aggforce_torch import LinearMap
    from aggforce_torch.utils.synth import synthesize_trajectory_device

    n = LINEAR_SWEEP_ATOMS
    base = np.random.default_rng(0).normal(scale=1.5, size=(n, 3))
    groups = [frozenset((i, i + 1)) for i in range(0, n // 2, 2)]
    cmap = LinearMap([[i] for i in range(0, n, max(1, n // 64))], n_fg_sites=n)
    coords, forces = synthesize_trajectory_device(
        base, groups, n_frames, seed=seed, motion_scale=0.02
    )
    return coords, forces, cmap, groups


def duplication_matrix(np, n, pairs):
    """Dense duplication matrix C of ``pairs``, built here apart from the
    program: sites joined by pairs (union-find) share one column."""
    parent = list(range(n))

    def root(i):
        while parent[i] != i:
            i = parent[i]
        return i

    for pair in pairs:
        i, j = sorted(pair)
        parent[root(j)] = root(i)
    roots = [root(i) for i in range(n)]
    col = {r: c for c, r in enumerate(sorted(set(roots)))}
    mat = np.zeros((n, len(col)))
    mat[np.arange(n), [col[r] for r in roots]] = 1.0
    return mat


def sweep_witness(torch, np, forces, cmap, constraints):
    """The float64 witness, built apart from the program's Gram and solver:
    C from ``duplication_matrix``, the Gram (F C)^T (F C) from dense float64
    products on the card over WITNESS_BLOCK-frame blocks (a ragged last
    block), and the equilibrated KKT system solved by numpy on the host.
    Returns its (S, N) force map on the card, float64."""
    con_np = duplication_matrix(np, cmap.n_fg_sites, constraints)
    con = torch.as_tensor(con_np, device="cuda")
    r, n = con.shape[1], forces.shape[1]
    t0 = time.perf_counter()
    gram = torch.zeros((r, r), dtype=torch.float64, device="cuda")
    for start in range(0, forces.shape[0], WITNESS_BLOCK):
        rows = forces[start : start + WITNESS_BLOCK].double().permute(0, 2, 1)
        design = rows.reshape(-1, n) @ con
        gram += design.T @ design
    torch.cuda.synchronize()
    gram_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p = gram.cpu().numpy()
    p = p / (np.trace(p) / r)
    a = cmap.standard_matrix @ con_np
    s = a.shape[0]
    kkt = np.block([[p, a.T], [a, np.zeros((s, s))]])
    rhs = np.vstack([np.zeros((r, s)), np.eye(s)])
    x = np.linalg.solve(kkt, rhs)[:r]
    log(f"  float64 witness: dense Gram on the card {gram_s:.3f} s (R = {r}, "
        f"{WITNESS_BLOCK}-frame blocks), numpy KKT solve {time.perf_counter() - t0:.3f} s")
    return torch.as_tensor(con_np @ x, device="cuda").T


def gauss_witness(torch, np, forces, cmap, groups, seed):
    """The float64 witness of a config-#2 fit, built apart from the program:
    the noise draw replayed from a CUDA generator seeded like the augmenter
    (``torch.randn`` of (T, S*3) float32), the augmented arrays in float64
    by their formulas ([x | Mx + sd eps], [f + kbt M^T eps sd/var |
    -kbt eps sd/var]), C from ``duplication_matrix``, a dense float64 Gram
    on the card, and the equilibrated KKT system of [0 | I] F^T = I solved
    by numpy. Returns (its (S, N + S) force map, the augmented forces), on
    the card, float64."""
    t, n = forces.shape[:2]
    s = cmap.n_cg_sites
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    eps = torch.randn((t, s * 3), generator=gen, device="cuda", dtype=torch.float32)
    resid = eps.double().reshape(t, s, 3) * (GAUSS_VAR**0.5 / GAUSS_VAR)
    m = torch.as_tensor(cmap.standard_matrix, device="cuda")
    ext_f = torch.cat(
        [forces.double() + KBT * torch.einsum("sn,tsd->tnd", m, resid), -KBT * resid], dim=1
    )
    con_np = duplication_matrix(np, n + s, groups)
    con = torch.as_tensor(con_np, device="cuda")
    design = ext_f.permute(0, 2, 1).reshape(-1, n + s) @ con
    p = (design.T @ design).cpu().numpy()
    r = p.shape[0]
    p = p / (np.trace(p) / r)
    a = np.hstack([np.zeros((s, n)), np.eye(s)]) @ con_np
    kkt = np.block([[p, a.T], [a, np.zeros((s, s))]])
    x = np.linalg.solve(kkt, np.vstack([np.zeros((r, s)), np.eye(s)]))[:r]
    cond = float(np.linalg.cond(p))
    log(f"  float64 witness: R = {r} reduced columns of {n + s} augmented sites, "
        f"condition number of the equilibrated Gram {cond:.3e}")
    return torch.as_tensor(con_np @ x, device="cuda").T, ext_f


def gauss_fit_gates(torch, np, tmap, fault, forces, cmap, groups, seed):
    """Gates 1 and 2 of config #2 on a ``joptgauss_map`` fit with ``seed``:
    orthogonality of the augmented map and shared columns for the pairs,
    and its mapped forces against the float64 witness (the planted fault, a
    fit without constraints, must miss it)."""
    linear_map_gates(torch, np, tmap.tmap, tmap.tmap.coord_map, set(groups))
    witness, ext_f = gauss_witness(torch, np, forces, cmap, groups, seed)
    expect = torch.einsum("sn,tnd->tsd", witness, ext_f)
    errs = {}
    for name, tm in (("joptgauss_map fit (main path)", tmap),
                     ("planted fault: constraints=set()", fault)):
        fmat = torch.as_tensor(tm.tmap.force_map.standard_matrix, device="cuda").double()
        errs[name] = rel_rms(torch, torch.einsum("sn,tnd->tsd", fmat, ext_f), expect)
        log(f"  {name}: mapped augmented forces vs the float64 witness, rel RMS "
            f"{errs[name]:.3e} (limit {GAUSS_REL_RMS_LIMIT:.0e})")
    if not errs["joptgauss_map fit (main path)"] <= GAUSS_REL_RMS_LIMIT:
        fail("config #2: the fit's mapped forces miss the float64 witness")
    if not errs["planted fault: constraints=set()"] > GAUSS_REL_RMS_LIMIT:
        fail("config #2: the witness gate does not reject the planted fault")


def staged_gates(torch, np, traj, cmap, groups):
    """Gate 3: ``stagedjoptgauss_map`` on its fused path and on its piecewise
    path (AGGFORCE_STAGED_FUSED=0) with one seed: the same draw, the maps
    within the JAX package's tolerances, the same mapped coordinates under
    one seed; the fused path taken without a miss. Gate 4: the force
    variant's noise contribution. Returns the fused map and the times."""
    import os

    from aggforce_torch.qp import stagedjforcegauss_map, stagedjoptgauss_map
    from aggforce_torch.qp.qplinear import fit_routes
    from aggforce_torch.trajectory import gaussian

    kw = dict(var=GAUSS_VAR, kbt=KBT, constraints=set(groups), seed=11)
    draws, real = [], gaussian._standard_normal

    def recording(*args):
        out = real(*args)
        draws.append(out.clone())
        return out

    gaussian._standard_normal = recording
    try:
        fit_routes.clear()
        fused = stagedjoptgauss_map(traj, cmap, **kw)
        routes = dict(fit_routes)
        os.environ["AGGFORCE_STAGED_FUSED"] = "0"
        try:
            piece = stagedjoptgauss_map(traj, cmap, **kw)
        finally:
            del os.environ["AGGFORCE_STAGED_FUSED"]
    finally:
        gaussian._standard_normal = real
    log(f"config #2 staged: fused fit routes {routes} (must read staged_fused 1 and "
        f"no staged_fused_missed)")
    if routes.get("staged_fused") != 1 or "staged_fused_missed" in routes:
        fail("config #2: the staged fit did not take its fused path")
    same_draw = len(draws) == 2 and torch.equal(draws[0], draws[1])
    log(f"  noise draws: {len(draws)} recorded, fused and piecewise identical: {same_draw}")
    if not same_draw:
        fail("config #2: the fused and piecewise staged fits drew different noise")

    def scaled(got, ref):
        got, ref = torch.as_tensor(got).double(), torch.as_tensor(ref).double()
        return float((got - ref).abs().max() / ref.abs().max())

    cf, ff = fused.map_arrays(traj.coords, traj.forces)
    cp, fp = piece.map_arrays(traj.coords, traj.forces)
    checks = {
        "premap force map": (scaled(fused[1].force_map.standard_matrix,
                                    piece[1].force_map.standard_matrix), STAGED_PRE_TOL),
        "second-stage force map": (scaled(fused[0].tmap.force_map.standard_matrix,
                                          piece[0].tmap.force_map.standard_matrix),
                                   STAGED_POST_TOL),
        "mapped coordinates (abs)": (float((cf - cp).abs().max()), STAGED_COORD_TOL),
        "mapped forces": (scaled(ff, fp), STAGED_POST_TOL),
    }
    for name, (err, lim) in checks.items():
        log(f"  fused vs piecewise {name}: {err:.3e} (limit {lim:.0e}; of the "
            f"largest entry unless abs)")
        if not err <= lim:
            fail(f"config #2: fused and piecewise staged fits differ in the {name}")
    if cf.device.type != "cuda":
        fail("config #2: the staged map's output left the card")

    force_map = stagedjforcegauss_map(traj, cmap, **kw)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        stagedjforcegauss_map(traj, cmap, contribution_tolerance=-1.0, **kw)
    remaining = float(str(caught[-1].message).rsplit(" ", 1)[1].rstrip("."))
    pre_f = force_map[1](traj).forces
    drift = float((force_map(traj).forces - pre_f).abs().max() / pre_f.std())
    log(f"config #2 force variant: remaining noise contribution {remaining:.3e} "
        f"(limit {REMAINING_LIMIT:.0e}); its mapped forces off the premap's by "
        f"{drift:.3e} of their standard deviation")
    if not 0.0 <= remaining <= REMAINING_LIMIT:
        fail("config #2: the force variant leaves a noise contribution")

    def timed(env):
        out = []
        for _ in range(3):
            if env:
                os.environ["AGGFORCE_STAGED_FUSED"] = "0"
            try:
                t0 = time.perf_counter()
                stagedjoptgauss_map(traj, cmap, **kw)
                torch.cuda.synchronize()
                out.append(time.perf_counter() - t0)
            finally:
                os.environ.pop("AGGFORCE_STAGED_FUSED", None)
        return out

    times = {"fused": timed(False), "piecewise": timed(True)}
    for name, ts in times.items():
        log(f"config #2 stagedjoptgauss_map {name}: {', '.join(f'{x:.4f}' for x in ts)} s "
            f"-> min {min(ts):.4f} s, {traj.coords.shape[0] / min(ts):.1f} frames/s")
    return fused, times


def mscg_gate(torch, np, jopt, staged, traj, cmap, groups):
    """Gate 5: MSCG projections of ``joptgauss_map``'s and
    ``stagedjoptgauss_map``'s mapped data (one application of each to the
    whole trajectory) onto MSCG_SAMPLES random fields: correlation above
    MSCG_CORR_LIMIT and relative difference of the means below
    MSCG_REL_LIMIT. The negative control, the joptgauss forces scaled by 1.5
    (a map with M F^T = 1.5 I), must fail. A second control is printed, not
    gated: noised coordinates with the noise-free linear map's forces (the
    noise correction left out). Returns the seconds of one projection at
    MSCG_TIMED_SAMPLES."""
    from aggforce_torch.mapval import random_force_proj
    from aggforce_torch.qp import qp_linear_map

    ca, fa = jopt.map_arrays(traj.coords, traj.forces)
    cb, fb = staged.map_arrays(traj.coords, traj.forces)
    _, f_lin = qp_linear_map(traj, cmap, constraints=set(groups)).map_arrays(
        traj.coords, traj.forces
    )

    def proj(c, f, n=MSCG_SAMPLES):
        return np.array(random_force_proj(
            c, f, n_samples=n, randg=np.random.default_rng(1234), average=False,
            **MSCG_FIELDS,
        ))

    def stats(pa, pb):
        corr = float(np.corrcoef(pa, pb)[0, 1])
        return corr, float(abs(pa.mean() - pb.mean()) / (abs(pa.mean()) + 1e-12))

    pa, pb = proj(ca, fa), proj(cb, fb)
    corr, rel = stats(pa, pb)
    c_corr, c_rel = stats(proj(ca, 1.5 * fa), pb)
    u_corr, u_rel = stats(proj(ca, f_lin), pb)
    log(f"config #2 MSCG ({MSCG_SAMPLES} random fields, {traj.coords.shape[0]} frames): "
        f"joptgauss vs stagedjoptgauss correlation {corr:.4f} (limit > {MSCG_CORR_LIMIT}), "
        f"relative difference {rel:.4f} (limit < {MSCG_REL_LIMIT}); negative control "
        f"(joptgauss forces x 1.5, M F^T = 1.5 I): correlation {c_corr:.4f}, relative "
        f"difference {c_rel:.4f} (must fail); not gated, noised coordinates with the "
        f"noise-free linear map's forces: correlation {u_corr:.4f}, relative "
        f"difference {u_rel:.4f}")
    if not (corr > MSCG_CORR_LIMIT and rel < MSCG_REL_LIMIT):
        fail("config #2: the two optimized maps disagree on MSCG projections")
    if c_corr > MSCG_CORR_LIMIT and c_rel < MSCG_REL_LIMIT:
        fail("config #2: the MSCG check does not reject its negative control")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proj(ca, fa, MSCG_TIMED_SAMPLES)
    return time.perf_counter() - t0


def phase_gauss_config2(torch, np, coords_np, forces_np, cmap, groups, smi):
    """Config #2 (bench.py:711-781) on phase 4's fixture, nothing cut: the
    Gaussian noised maps on CUDA tensors, gates 1-7, and their times."""
    import aggforce_torch
    from aggforce_torch import Trajectory, joptgauss_map, stagedjslicegauss_map
    from aggforce_torch.trajectory import CoordsTrajectory

    coords = torch.as_tensor(coords_np, device="cuda")
    forces = torch.as_tensor(forces_np, device="cuda")
    traj = Trajectory(coords=coords, forces=forces)
    n_frames = coords.shape[0]
    constraints = set(groups)

    def fit(seed, c=constraints):
        return joptgauss_map(traj, cmap, var=GAUSS_VAR, kbt=KBT, constraints=c, seed=seed)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    fit(7)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    fit_s = []
    for seed in GAUSS_SEEDS:
        t0 = time.perf_counter()
        tmap = fit(seed)
        torch.cuda.synchronize()
        fit_s.append(time.perf_counter() - t0)
    fit_min, fit_med = min(fit_s), float(np.median(fit_s))
    log(f"config #2 joptgauss_map ({n_frames} frames, {cmap.n_fg_sites} atoms, "
        f"S = {cmap.n_cg_sites}, var {GAUSS_VAR}): first {first_s:.4f} s; seeds "
        f"{GAUSS_SEEDS[0]}-{GAUSS_SEEDS[-1]}: {', '.join(f'{x:.4f}' for x in fit_s)} s -> "
        f"min {fit_min:.4f} s, median {fit_med:.4f} s, {n_frames / fit_min:.1f} "
        f"frames/s (min), {n_frames / fit_med:.1f} frames/s (median) ({smi})")
    apply_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = tmap(traj)
        torch.cuda.synchronize()
        apply_s.append(time.perf_counter() - t0)
    finite = bool(torch.isfinite(out.forces).all())
    log(f"config #2 apply: first {apply_s[0]:.4f} s, second {apply_s[1]:.4f} s "
        f"({n_frames / apply_s[1]:.1f} frames/s); output on {out.forces.device}, "
        f"{tuple(out.forces.shape)}, finite {finite}")
    if out.forces.device.type != "cuda" or out.coords.device.type != "cuda":
        fail("config #2: the applied map's output left the card")
    if out.forces.shape != (n_frames, cmap.n_cg_sites, 3) or not finite:
        fail("config #2: the applied map's forces are misshapen or not finite")

    log("config #2 gates 1-2 (orthogonality, float64 witness):")
    gauss_fit_gates(
        torch, np, tmap, fit(GAUSS_SEEDS[-1], set()), forces, cmap, groups,
        GAUSS_SEEDS[-1],
    )
    staged, staged_times = staged_gates(torch, np, traj, cmap, groups)

    slice_map = stagedjslicegauss_map(
        CoordsTrajectory(coords=coords), cmap, var=GAUSS_VAR, kbt=KBT, seed=8,
        warn_input_forces=False,
    )
    sc, sf = slice_map.map_arrays(coords, None)
    m = torch.as_tensor(cmap.standard_matrix, dtype=torch.float32, device="cuda")
    expect = -KBT * (sc - torch.einsum("sn,tnd->tsd", m, coords)) / GAUSS_VAR
    slice_err = float((sf - expect).abs().max() / expect.abs().max())
    log(f"config #2 stagedjslicegauss_map: forces on {sf.device}, off -kbt (y - Mx)/var "
        f"by {slice_err:.3e} of the largest entry (limit 1e-3)")
    if sf.device.type != "cuda" or not slice_err <= 1e-3:
        fail("config #2: the slice map's forces are not the noise forces")

    res = aggforce_torch.project_forces(
        coords, forces, cmap, method=joptgauss_map, var=GAUSS_VAR, kbt=KBT, seed=3
    )
    log(f"config #2 project_forces(method=joptgauss_map): {len(res['constraints'])} "
        f"pairs detected (equal: {res['constraints'] == constraints}), mapped forces "
        f"on {res['mapped_forces'].device}, residual {res['residual']:.6g}")
    if res["constraints"] != constraints or res["mapped_forces"].device.type != "cuda":
        fail("config #2: project_forces(method=joptgauss_map) missed the pairs or the card")

    proj_s = mscg_gate(torch, np, tmap, staged, traj, cmap, groups)
    log(f"config #2 random_force_proj at n_samples = {MSCG_TIMED_SAMPLES}: {proj_s:.4f} s "
        f"({smi})")

    matmul = torch.backends.cuda.matmul
    matmul.allow_tf32 = True
    try:
        on = fit(GAUSS_SEEDS[0]).tmap.force_map.standard_matrix
        still_on = matmul.allow_tf32
    finally:
        matmul.allow_tf32 = False
    off = fit(GAUSS_SEEDS[0]).tmap.force_map.standard_matrix
    same = bool(np.array_equal(on, off))
    log(f"config #2 with TF32 on: the fit reads the bits of the fit with TF32 off: "
        f"{same}; switch still on afterwards: {still_on}")
    if not same or not still_on:
        fail("config #2: with TF32 on, the fit moved or the switch was reset")

    wall_s, busy_s, kinds = fit_breakdown(
        torch, lambda: fit(GAUSS_SEEDS[0]), fit_med, top=10, kind_of=linear_kind
    )
    peak = torch.cuda.max_memory_allocated()
    read_counts("config #2, every Gaussian path", 1)
    log(f"config #2: peak device memory {peak / 2**20:.1f} MiB; profiled fit "
        f"{busy_s / wall_s:.1%} busy ({smi})")
    return {
        "first_s": first_s, "fit_min_s": fit_min, "fit_med_s": fit_med,
        "apply_s": apply_s, "staged_s": staged_times, "proj_s": proj_s,
    }


def phase_linear_sweep(torch, np, smi):
    """The linear sweep end to end: detection on 256 frames and two
    qp_linear_map fits at full width, a profiled fit, the Gram against its
    bound, and the mapped forces of 4,096 frames against a float64 witness
    (the planted fault, a fit without constraints, must fail)."""
    from aggforce_torch import Trajectory, guess_pairwise_constraints
    from aggforce_torch.qp import qp_linear_map
    from aggforce_torch.qp.qplinear import FRAME_BLOCK, _linear_gram, constraint_labels
    from aggforce_torch.utils.device import full_fp32

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    coords, forces, cmap, groups = linear_sweep_fixture(torch)
    torch.cuda.synchronize()
    log(f"linear sweep fixture on the card: {tuple(coords.shape)} frames x atoms "
        f"x 3 (coords and forces {forces.numel() * 4 / 1e9:.2f} GB each), "
        f"{cmap.n_cg_sites} cg sites, {time.perf_counter() - t0:.3f} s")
    traj = Trajectory(coords=coords, forces=forces)

    def detect_and_fit():
        t0 = time.perf_counter()
        found = guess_pairwise_constraints(coords[:256])
        det_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tmap = qp_linear_map(traj, cmap, constraints=found)
        torch.cuda.synchronize()
        return found, tmap, det_s, time.perf_counter() - t0

    reset_counts()
    found, tmap, det_s, first_s = detect_and_fit()
    routes = read_counts("linear sweep, first fit", 1)
    log(f"linear sweep: detection {det_s:.3f} s on 256 frames ({len(found)} "
        f"pairs, equal to the {len(groups)} synthesized: {found == set(groups)}); "
        f"first qp_linear_map {first_s:.3f} s -> "
        f"{LINEAR_SWEEP_FRAMES / first_s:.1f} frames/s")
    if found != set(groups):
        fail("linear sweep: the detected constraints are not the 750 pairs")
    if routes != {"device": 1}:
        fail(f"linear sweep: the fit did not take the device route alone: {routes}")
    linear_map_gates(torch, np, tmap, cmap, found)
    reset_counts()
    _, tmap, det2_s, second_s = detect_and_fit()
    routes = read_counts("linear sweep, second fit", 1)
    if routes != {"device": 1}:
        fail(f"linear sweep: the second fit did not take the device route: {routes}")
    log(f"linear sweep, second: detection {det2_s:.3f} s, qp_linear_map "
        f"{second_s:.3f} s -> {LINEAR_SWEEP_FRAMES / second_s:.1f} frames/s ({smi})")
    fit_breakdown(
        torch, lambda: qp_linear_map(traj, cmap, constraints=found), second_s,
        top=10, kind_of=linear_kind,
    )

    labels_np, r = constraint_labels(cmap.n_fg_sites, found)
    labels = torch.as_tensor(labels_np, dtype=torch.int64, device="cuda")
    with full_fp32():
        gram_ms = cuda_ms(torch, lambda: _linear_gram(forces, labels, r), reps=3)
    # the Gram is symmetric: the bound counts its R(R+1)/2 unique entries, as
    # the kernel table does; the addmm computes all R^2
    flops = 3.0 * LINEAR_SWEEP_FRAMES * r * (r + 1)
    full_flops = 2.0 * 3 * LINEAR_SWEEP_FRAMES * r * r
    n_bytes = 4.0 * (forces.numel() + r * (r + 1) / 2)
    bound_ms = max(flops / PEAK_FP32_FLOPS, n_bytes / PEAK_BYTES) * 1e3
    n_blocks = -(-LINEAR_SWEEP_FRAMES // FRAME_BLOCK)
    log(f"linear sweep Gram (R = {r}, T = {LINEAR_SWEEP_FRAMES}, block transposes, "
        f"index_add_ and addmm over {n_blocks} blocks): {gram_ms:.3f} ms; "
        f"{flops:.4g} FLOP over the unique entries, fp32 bound {bound_ms:.3f} ms "
        f"(operations at {PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s; the bytes take "
        f"{n_bytes / PEAK_BYTES * 1e3:.3f} ms), {gram_ms / bound_ms:.2f}x the bound; "
        f"the full product the addmm computes is {full_flops:.4g} FLOP -> "
        f"{full_flops / gram_ms / 1e9:.2f} TFLOP/s, its bound "
        f"{full_flops / PEAK_FP32_FLOPS * 1e3:.3f} ms ({smi})")

    witness = sweep_witness(torch, np, forces, cmap, found)
    head = forces[:SWEEP_CHECK_FRAMES]
    expect = torch.einsum("sn,tnd->tsd", witness, head.double())
    reset_counts()
    fault = qp_linear_map(traj, cmap, constraints=set())
    read_counts("linear sweep, planted fault", 0)
    errs = {}
    for name, tm in (("device fit (main path)", tmap),
                     ("planted fault: constraints=set()", fault)):
        mapped = tm(Trajectory(coords=coords[:SWEEP_CHECK_FRAMES], forces=head)).forces
        errs[name] = rel_rms(torch, mapped, expect)
        log(f"  {name}: mapped forces of {SWEEP_CHECK_FRAMES} frames vs the "
            f"float64 witness, rel RMS {errs[name]:.3e} (limit {SWEEP_REL_RMS_LIMIT:.0e}); "
            f"finite {bool(torch.isfinite(mapped).all())}")
    if not errs["device fit (main path)"] <= SWEEP_REL_RMS_LIMIT:
        fail("linear sweep: the fit's mapped forces miss the float64 witness")
    if not errs["planted fault: constraints=set()"] > SWEEP_REL_RMS_LIMIT:
        fail("linear sweep: the witness gate does not reject the planted fault")
    log(f"linear sweep: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB ({smi})")


def cv_witness(torch, grams, rows, b_all, l2s):
    """Float64 scores (n_l2, k) of every (l2, fold) cell, solved on the card
    apart from the program: ``eqp_solve_host``'s algorithm (equilibrated
    KKT system regularized by 1e-12, LU, four refinement sweeps against the
    unregularized system), batched over sites. Also returns each cell's
    largest condition number over its sites (n_l2, k): the largest
    eigenvalue by 30 power steps over the least one's lower bound, the
    normalized l2 (the Gram is positive semidefinite)."""
    g = grams.double()
    a = rows.double()
    k, s_dim, n = g.shape[0], g.shape[1], g.shape[-1]
    m = a.shape[2]
    eye_n = torch.eye(n, dtype=torch.float64, device=g.device)
    eye_m = torch.eye(m, dtype=torch.float64, device=g.device)
    norm = torch.linalg.norm(a, dim=3, keepdim=True) + 1e-300
    an, bn = a / norm, b_all.double()[..., None] / norm
    out = torch.zeros((len(l2s), k), dtype=torch.float64)
    cond = torch.zeros((len(l2s), k), dtype=torch.float64)
    for i, l2 in enumerate(l2s):
        p = g.sum(0)[None] - g + l2 * eye_n
        scale = torch.diagonal(p, dim1=2, dim2=3).sum(-1) / n + 1e-300
        pn = p / scale[..., None, None]
        v = torch.ones((k, s_dim, n, 1), dtype=torch.float64, device=g.device)
        for _ in range(30):
            v = pn @ v
            v = v / torch.linalg.norm(v, dim=2, keepdim=True)
        top_eig = torch.linalg.norm(pn @ v, dim=2)[..., 0]
        cond[i] = torch.amax(top_eig / (l2 / scale), dim=1).cpu()
        top = torch.cat([pn, an.transpose(2, 3)], dim=3)
        k_true = torch.cat([top, torch.cat([an, torch.zeros_like(eye_m).expand(k, s_dim, m, m)], dim=3)], dim=2)
        k_reg = k_true + 1e-12 * torch.block_diag(eye_n, -eye_m)
        rhs = torch.cat([torch.zeros((k, s_dim, n, 1), dtype=torch.float64, device=g.device), bn], dim=2)
        lu, piv = torch.linalg.lu_factor(k_reg)
        z = torch.linalg.lu_solve(lu, piv, rhs)
        for _ in range(4):
            z = z + torch.linalg.lu_solve(lu, piv, rhs - k_true @ z)
        x = z[:, :, :n, 0]
        out[i] = torch.einsum("fsi,fsij,fsj->f", x, g, x).cpu()
    return out.numpy(), cond.numpy()


def cv_cells(torch, np, grams, rows, b_all, denoms):
    """Every (l2, fold) cell of the config-#4 CV from its device problem, in
    ``fused_gb_cv``'s memory blocks: (scores (n_l2, k) float64, residuals
    (n_l2, k), [(l2 values of a block, its peak device bytes above what was
    allocated before it, its predicted bytes)])."""
    from aggforce_torch.qp.cv import _featurized_solve_scores, _kkt_bytes, _l2_blocks

    k_exp, m_rows, s_dim = grams.shape[-1], rows.shape[2], grams.shape[1]
    per_problem = _kkt_bytes(k_exp, m_rows)
    block = _l2_blocks(len(CV_L2S), per_problem, CV_FOLDS * s_dim)
    qfs, resids, peaks = [], [], []
    for i in range(0, len(CV_L2S), block):
        l2s = CV_L2S[i : i + block]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        qf, resid = _featurized_solve_scores(
            grams, rows, b_all, torch.as_tensor(l2s, dtype=torch.float32, device=grams.device)
        )
        torch.cuda.synchronize()
        peaks.append((l2s, torch.cuda.max_memory_allocated() - base,
                      per_problem * CV_FOLDS * s_dim * len(l2s)))
        qfs.append(qf.cpu().numpy())
        resids.append(resid.cpu().numpy())
    qf = np.concatenate(qfs).astype(np.float64) / denoms
    return qf, np.concatenate(resids), peaks


def cv_cell_gate(torch, np, table, grams, rows, b_all, folds, escalated):
    """Phase 5's gate of a config-#4 CV table on the fold Grams, constraint
    rows and targets it was computed from: every (l2, fold) cell within
    CV_F64_REL_LIMIT + 4 * cond * 2**-52 of a float64 witness solved apart
    from the program on the same Grams, each l2's score (escalated cells
    hold the host oracle's, the same method) within its largest cell limit
    of the witness's mean, and ``escalated`` cells counted as the residuals
    say. Returns the cells, the witnesses, the escalation mask, the limits,
    the denominators and the failures."""
    denoms = np.array([3 * len(f) * grams.shape[1] for f in folds], dtype=np.float64)
    cells, resid, peaks = cv_cells(torch, np, grams, rows, b_all, denoms)
    for l2s, peak, predicted in peaks:
        log(f"  solve block l2 {l2s}: peak device memory {peak / 2**30:.3f} GiB above "
            f"the Grams (predicted by _l2_blocks' accounting {predicted / 2**30:.3f} GiB)")
    t0 = time.perf_counter()
    exact, cond = cv_witness(torch, grams, rows, b_all, CV_L2S)
    exact = exact / denoms
    limit = CV_F64_REL_LIMIT + cond * F64_EPS
    log(f"  float64 witness on the card, all {cells.size} cells: "
        f"{time.perf_counter() - t0:.2f} s (fold Grams {grams.dtype})")
    esc = ~(resid <= 1e-4)  # NaN-aware, as fused_gb_cv decides
    rel = np.abs(cells - exact) / np.abs(exact)
    failed = []
    for i, l2 in enumerate(CV_L2S):
        got = table[float(l2)][0]
        table_rel = abs(got - exact[i].mean()) / abs(exact[i].mean())
        log(f"  l2 {l2:g}: CV score {got:.10g}; float64 witness {exact[i].mean():.10g} "
            f"(rel {table_rel:.2e}); condition up to {cond[i].max():.3g}, limit "
            f"{limit[i].max():.2e}; cells rel err {', '.join(f'{x:.2e}' for x in rel[i])}; "
            f"residuals {', '.join(f'{x:.1e}' for x in resid[i])}; escalated folds "
            f"{np.nonzero(esc[i])[0].tolist()}")
        if not table_rel <= limit[i].max():
            failed.append(f"the CV's score at l2 {l2:g} misses its float64 witness")
    worst = float(np.max(rel / limit))
    log(f"  config #4: {int(esc.sum())} escalated cells; every cell against the "
        f"float64 witness: largest rel err / its limit {worst:.3e} (must be <= 1)")
    if int(esc.sum()) != escalated:
        failed.append(f"the CV escalated {escalated} cells, its residuals say {int(esc.sum())}")
    if not worst <= 1.0:
        failed.append(f"a CV cell lies {worst:.3e} of its limit from its float64 score")
    return dict(cells=cells, exact=exact, esc=esc, limit=limit, denoms=denoms, failed=failed)


def phase_cv_config4(torch, np, coords_np, forces_np, cmap, groups, spec, smi):
    """Config #4: ``fused_gb_cv`` at the shape of bench.py's run_cv on the
    card. Gates: five launches of kernel 1 per CV; every cell within
    CV_F64_REL_LIMIT + 4 * cond * 2**-52 of float64 scores from the same
    Grams (``cv_cell_gate``); the
    refit of (fold 0, l2 = 1e3), scored by force_smoothness of its mapped
    holdout forces, within REFIT_REL_LIMIT of the cell, and a CV on fold
    Grams without the divergence term (the planted fault) outside it. Then
    times, frames/s, a profiled CV and the solve block's peak memory."""
    from aggforce_torch import Trajectory
    from aggforce_torch.agg import force_smoothness
    from aggforce_torch.ops.gram import site_grams
    from aggforce_torch.qp.cv import (
        _featurized_cv_problem,
        _featurized_solve_scores,
        _fold_grams,
        _host_featurized_scores,
        fused_gb_cv,
    )
    from aggforce_torch.qp.fusedfeat import fused_gb_linear_map
    from aggforce_torch.qp.qplinear import fit_routes

    coords = torch.as_tensor(coords_np, device="cuda")
    forces = torch.as_tensor(forces_np, device="cuda")
    constraints = set(groups)

    def cv():
        return fused_gb_cv(
            coords, forces, cmap, constraints, kbt=KBT, spec=spec, l2_values=CV_L2S,
            n_folds=CV_FOLDS, n_constraint_frames=20,
            rng=np.random.default_rng(CV_SEED),
        )

    reset_counts()
    t0 = time.perf_counter()
    table = cv()  # ends in the grid's one host sync
    first_s = time.perf_counter() - t0
    launches = site_grams.launches
    escalated = fit_routes.get("cv_escalated_cells", 0)
    log(f"config #4: first fused_gb_cv {first_s:.3f} s; site_grams launches "
        f"{launches} (must be {CV_FOLDS}); escalated cells {escalated}")
    if launches != CV_FOLDS:
        fail(f"config #4: the CV launched site_grams {launches} times, not {CV_FOLDS}")
    cv_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        cv()
        cv_s.append(time.perf_counter() - t0)
    cv_min, cv_med = min(cv_s), float(np.median(cv_s))
    log(f"config #4 steady-state CV ({len(CV_L2S)} l2 values x {CV_FOLDS} folds x "
        f"{cmap.n_cg_sites} sites): min {cv_min:.4f} s, median {cv_med:.4f} s -> "
        f"{N_FRAMES / cv_min:.1f} frames/s (min), {N_FRAMES / cv_med:.1f} frames/s "
        f"(median); all {', '.join(f'{x:.4f}' for x in cv_s)} s ({smi})")

    def problem(gram_fn=_fold_grams):
        return _featurized_cv_problem(
            coords, forces, cmap, constraints, KBT, spec, CV_FOLDS, 20,
            np.random.default_rng(CV_SEED), gram_fn=gram_fn,
        )

    grams, rows, b_all, folds, samples = problem()
    gate = cv_cell_gate(torch, np, table, grams, rows, b_all, folds, escalated)
    cells, exact, esc, limit, failed = (
        gate[k] for k in ("cells", "exact", "esc", "limit", "failed")
    )
    denoms = gate["denoms"]
    li = CV_L2S.index(1e3)
    t0 = time.perf_counter()
    one = np.zeros(cells.shape, dtype=bool)
    one[li, 0] = True
    host_cell = _host_featurized_scores(
        *(x.cpu().numpy().astype(np.float64) for x in (grams, rows, b_all)),
        CV_L2S, np.zeros(cells.shape), one,
    )[li, 0] / denoms[0]
    host_rel = abs(host_cell - exact[li, 0]) / abs(exact[li, 0])
    log(f"  the program's host oracle (_host_featurized_scores) on (fold 0, l2 1e3): "
        f"{time.perf_counter() - t0:.2f} s, {host_rel:.2e} off the card's float64 witness")
    if not host_rel <= 1e-9:
        failed.append("the card's float64 witness disagrees with the host oracle")

    # gate (c): refit (fold 0, l2 = 1e3) on the train frames with that
    # fold's constraint frames, and score its mapped holdout forces
    train = np.concatenate(folds[1:])
    position = {int(frame): i for i, frame in enumerate(train)}

    class FoldSample:
        """Hands the fit the fold's constraint frames, as train positions."""

        def choice(self, n, size, replace):
            return np.array([position[int(f)] for f in samples[0]])

    train_dev = torch.as_tensor(train, device="cuda")
    hold = torch.as_tensor(folds[0], device="cuda")
    refit = fused_gb_linear_map(
        Trajectory(coords=coords[train_dev], forces=forces[train_dev]), cmap,
        kbt=KBT, spec=spec, constraints=constraints, l2_regularization=1e3,
        n_constraint_frames=20, constraint_rng=FoldSample(),
    )
    direct = force_smoothness(refit.force_map(forces[hold], coords[hold]))
    fault_problem = problem(without_divergence)[:3]
    fault_qf, fault_resid = _featurized_solve_scores(
        *fault_problem, torch.as_tensor([1e3], dtype=torch.float32, device="cuda")
    )
    fault_qf = fault_qf.cpu().numpy().astype(np.float64)
    if not float(fault_resid[0, 0]) <= 1e-4:  # escalated, as fused_gb_cv would
        fault_qf = _host_featurized_scores(
            *(x.cpu().numpy().astype(np.float64) for x in fault_problem), [1e3],
            fault_qf, np.array([[True] + [False] * (CV_FOLDS - 1)]),
        )
    fault = float(fault_qf[0, 0]) / denoms[0]
    cv_cell = exact[li, 0] if esc[li, 0] else cells[li, 0]
    refit_rel = abs(cv_cell - direct) / direct
    fault_rel = abs(fault - direct) / direct
    log(f"  refit of (fold 0, l2 1e3) on its {len(train)} train frames: holdout "
        f"force_smoothness {direct:.8g}, CV cell {cv_cell:.8g}, rel "
        f"{refit_rel:.3e} (limit {REFIT_REL_LIMIT:.0e}); planted fault (fold Grams "
        f"without the divergence term) {fault:.8g}, rel {fault_rel:.3e}")
    if not refit_rel <= REFIT_REL_LIMIT:
        failed.append("the refit's holdout score misses the CV cell")
    if not fault_rel > REFIT_REL_LIMIT:
        failed.append("the refit gate does not reject the planted fault")
    if failed:
        fail("config #4: " + "; ".join(failed))
    del grams, rows, b_all
    fit_breakdown(torch, cv, cv_med)
    # phase 14 holds the one-rank mesh CV to this table, bit for bit
    return launches, first_s, cv_min, cv_med, table


def linear_cv_float64(torch, np, forces, cmap, groups):
    """Config #1's linear CV scores (one per CV_L2S value) solved in float64
    on the host from the folds' float32 Grams (``_host_linear_scores``)."""
    from aggforce_torch.qp.cv import _host_linear_scores
    from aggforce_torch.qp.qplinear import _linear_gram, _reduced, constraint_labels
    from aggforce_torch.utils.device import full_fp32

    forces = torch.as_tensor(forces, device="cuda")
    folds = cv_folds(np)
    labels_np, r = constraint_labels(cmap.n_fg_sites, set(groups))
    labels = torch.as_tensor(labels_np, dtype=torch.int64, device="cuda")
    with full_fp32():
        grams = torch.stack([
            _linear_gram(forces[torch.as_tensor(idx, device="cuda")].float(), labels, r)
            for idx in folds
        ])
    a_mat = _reduced(torch.as_tensor(cmap.standard_matrix, dtype=torch.float32,
                                     device="cuda"), labels, r)
    ridge = np.diag(np.bincount(labels_np, minlength=r)).astype(np.float64)
    exact = _host_linear_scores(
        grams.cpu().numpy().astype(np.float64), a_mat.cpu().numpy().astype(np.float64),
        np.eye(cmap.n_cg_sites), ridge, CV_L2S, np.zeros((len(CV_L2S), CV_FOLDS)),
        np.ones((len(CV_L2S), CV_FOLDS), dtype=bool),
    ) / np.array([3 * len(f) * cmap.n_cg_sites for f in folds])
    return exact.mean(axis=1)


def phase_cv_grids(torch, np, coords_np, forces_np, cmap, groups):
    """``project_forces_grid_cv(fast=True)`` on the card: a (featurizer x l2)
    grid must equal ``fused_gb_cv_grid``'s table for the same generator and
    launch kernel 1 five times per featurizer; the linear grid at config #1
    (``linear_map_cv``) must lie within CV_REL_LIMIT of float64 scores and
    launch no Gram kernel. Constraints are detected (``constrained_inds="auto"``),
    the detection kernel once per grid."""
    import aggforce_torch
    from aggforce_torch import Curry, Multifeaturize, gb_feat, id_feat
    from aggforce_torch.agg import NRUNS_KNAME, SCORES_KNAME
    from aggforce_torch.constraints.finder import pair_moments
    from aggforce_torch.ops.gram import site_grams
    from aggforce_torch.qp import qp_feat_linear_map
    from aggforce_torch.qp.cv import fused_gb_cv_grid
    from aggforce_torch.qp.fusedfeat import recognize_canonical_featurizer

    coords = torch.as_tensor(coords_np, device="cuda")
    forces = torch.as_tensor(forces_np, device="cuda")
    feats = [
        Multifeaturize([id_feat, Curry(gb_feat, outer=OUTER, n_basis=nb, width=WIDTH)])
        for nb in (5, 7)
    ]
    l2s = [1e2, 1e3]
    reset_counts()
    t0 = time.perf_counter()
    out = aggforce_torch.project_forces_grid_cv(
        {"featurizer": feats, "l2_regularization": l2s}, coords, forces,
        n_folds=CV_FOLDS, rng=np.random.default_rng(CV_SEED), fast=True,
        coord_map=cmap, method=qp_feat_linear_map, kbt=KBT, n_constraint_frames=20,
    )
    grid_s = time.perf_counter() - t0
    launches = site_grams.launches
    grid_path = "featurized grid (project_forces_grid_cv)"
    DETECT_LAUNCHES[grid_path] = pair_moments.launches
    direct = fused_gb_cv_grid(
        coords, forces, cmap, set(groups), KBT,
        [recognize_canonical_featurizer(f) for f in feats], l2s, n_folds=CV_FOLDS,
        n_constraint_frames=20, rng=np.random.default_rng(CV_SEED),
    )
    worst, bitwise, runs = 0.0, True, set()
    for label, score in out[SCORES_KNAME].items():
        expect = direct[(feats.index(label.featurizer), float(label.l2_regularization))][0]
        worst = max(worst, abs(score - expect) / abs(expect))
        bitwise &= score == expect
        runs.add(out[NRUNS_KNAME][label])
    log(f"featurized grid through project_forces_grid_cv (n_basis 5 and 7 x l2 "
        f"{l2s}): {grid_s:.3f} s, site_grams launches {launches} (must be "
        f"{CV_FOLDS * len(feats)}); against fused_gb_cv_grid: largest rel diff "
        f"{worst:.3e}, bitwise equal {bitwise}; runs per point {sorted(runs)}; "
        f"pair_moments launches {DETECT_LAUNCHES[grid_path]} (must be 1)")
    if launches != CV_FOLDS * len(feats):
        fail(f"the featurized grid launched site_grams {launches} times")
    if DETECT_LAUNCHES[grid_path] != 1:
        fail(f"the featurized grid's detection launched its kernel "
             f"{DETECT_LAUNCHES[grid_path]} times, not once")
    if len(out[SCORES_KNAME]) != len(feats) * len(l2s) or runs != {CV_FOLDS}:
        fail("the featurized grid's table is not the grid")
    if not worst <= 1e-6:
        fail("the featurized grid through project_forces_grid_cv differs from fused_gb_cv_grid")

    reset_counts()
    lin = aggforce_torch.project_forces_grid_cv(
        {"l2_regularization": CV_L2S}, coords, forces, n_folds=CV_FOLDS,
        rng=np.random.default_rng(CV_SEED), fast=True, coord_map=cmap,
    )
    read_counts("config #1 linear CV through project_forces_grid_cv", 1)
    exact = linear_cv_float64(torch, np, forces, cmap, groups)
    worst = 0.0
    for i, (label, score) in enumerate(lin[SCORES_KNAME].items()):
        expect = float(exact[i])
        worst = max(worst, abs(score - expect) / expect)
    log(f"linear grid through project_forces_grid_cv (config #1, l2 {CV_L2S}): "
        f"largest rel err against float64 scores {worst:.3e} (limit {CV_REL_LIMIT:.0e})")
    if not worst <= CV_REL_LIMIT:
        fail("the linear CV's scores miss the float64 scores")
    return launches


def phase_batch(torch, np, coords_np, forces_np, cmap, groups, spec, single_med, smi):
    """The batch fits at config #3 (bench.py:887-927): 4 windows of 64 seeds,
    one untimed warm call and 3 timed calls. Gates: one kernel-1 launch per
    window, every fit finite, the first and last seed of each window within
    J_GAP_LIMIT of its float64 optimum; two seeds refitted singly are
    printed beside their batch fits."""
    from aggforce_torch import Trajectory
    from aggforce_torch.ops.gram import site_grams, site_grams_plain
    from aggforce_torch.qp.fusedfeat import fused_gb_linear_map, fused_gb_linear_map_batch

    coords = torch.as_tensor(coords_np, device="cuda")
    forces = torch.as_tensor(forces_np, device="cuda")
    traj = Trajectory(coords=coords, forces=forces)
    seeds = list(range(BATCH_WINDOWS * BATCH_WINDOW))
    kw = dict(kbt=KBT, spec=spec, constraints=set(groups), l2_regularization=L2)
    calls = []
    for call in range(4):
        reset_counts()
        t0 = time.perf_counter()
        maps = fused_gb_linear_map_batch(
            traj, cmap, seeds=seeds, flush_every=BATCH_WINDOW, **kw
        )
        torch.cuda.synchronize()
        calls.append(time.perf_counter() - t0)
        if site_grams.launches != BATCH_WINDOWS:
            fail(f"the batch fits launched site_grams {site_grams.launches} times, "
                 f"not once per window ({BATCH_WINDOWS})")
    timed = calls[1:]
    med = float(np.median(timed))
    n_fits = len(seeds)
    log(f"batch fits ({BATCH_WINDOWS} windows x {BATCH_WINDOW} seeds): warm call "
        f"{calls[0]:.3f} s, then {', '.join(f'{x:.4f}' for x in timed)} s; site_grams "
        f"launches {BATCH_WINDOWS} per call; median {med * 1e3 / n_fits:.3f} ms per "
        f"fit, {n_fits * N_FRAMES / med:.1f} frames/s pipelined (min "
        f"{min(timed) * 1e3 / n_fits:.3f} ms per fit); single fit median "
        f"{single_med * 1e3:.2f} ms, {N_FRAMES / single_med:.1f} frames/s ({smi})")
    coefs = torch.stack([m.force_map._coefs for m in maps])
    escalated = sum(bool(m.force_map.tags["escalated"]) for m in maps)
    finite = bool(torch.isfinite(coefs).all())
    log(f"  {len(maps)} fits, finite {finite}, escalated {escalated}, largest "
        f"solver_resid {max(m.force_map.tags['solver_resid'] for m in maps):.3e}")
    if len(maps) != n_fits or not finite:
        fail("the batch fits are not all finite")
    gaps = {}
    for w in range(BATCH_WINDOWS):
        for seed in (w * BATCH_WINDOW, (w + 1) * BATCH_WINDOW - 1):
            gram, rows, _ = fit_problem(
                torch, np, coords, forces, cmap, groups, spec, torch.float64,
                site_grams_plain, seed=seed,
            )
            gaps[seed], _ = objective_gap(
                np, gram.cpu().numpy(), rows.cpu().numpy(),
                np.stack(maps[seed].force_map.tags["coef_list"]).astype(np.float64),
            )
    log(f"  objective gap to the float64 optimum, first and last seed of each "
        f"window: {', '.join(f'{s}: {g:+.3e}' for s, g in gaps.items())} (limit "
        f"{J_GAP_LIMIT:.0e})")
    for seed in (seeds[0], seeds[-1]):
        single = fused_gb_linear_map(
            traj, cmap, constraint_rng=np.random.default_rng(seed), **kw
        ).force_map
        batch = maps[seed].force_map
        coef_diff = float((single._coefs - batch._coefs).abs().max())
        f_diff = float((single(forces, coords) - batch(forces, coords)).abs().max())
        log(f"  seed {seed} refitted singly: largest coefficient difference "
            f"{coef_diff:.3e}, largest mapped-force difference {f_diff:.3e}; "
            f"bitwise equal {bool(torch.equal(single._coefs, batch._coefs))}")
    bad = [s for s, g in gaps.items() if not g <= J_GAP_LIMIT]
    if bad:
        fail(f"batch fits of seeds {bad} miss the objective gate")
    return BATCH_WINDOWS, med / n_fits


def tf32_featurized_checks(torch, np, coords, forces, cmap, groups, spec):
    """The featurized paths and the linear map's application with TF32 on
    for the process: a config-#3 fit (also held to the objective gate), a
    ``FusedGBMap`` and a ``TLinearMap`` application and one CV cell must
    read what they read with TF32 off (within TF32_REL_LIMIT of the largest
    entry), and the switch must still be on afterwards. The planted check:
    the fit with every full-fp32 scope bypassed must move by more. Also
    times what entering and leaving the scope costs."""
    from aggforce_torch import Trajectory
    from aggforce_torch.ops.gram import site_grams_plain
    from aggforce_torch.ops.torchcore import trjdot
    from aggforce_torch.qp import qp_linear_map
    from aggforce_torch.qp.cv import fused_gb_cv
    from aggforce_torch.qp.fusedfeat import fused_gb_linear_map
    from aggforce_torch.utils.device import full_fp32

    traj = Trajectory(coords=coords, forces=forces)

    def fit():
        return fused_gb_linear_map(
            traj, cmap, kbt=KBT, spec=spec, constraints=set(groups),
            l2_regularization=L2, constraint_rng=np.random.default_rng(7),
        ).force_map

    # the maps whose applications are checked, fitted with TF32 off
    fused_map = fit()
    linear_map = qp_linear_map(traj, cmap, constraints=set(groups)).force_map

    def outputs():
        cell = fused_gb_cv(
            coords, forces, cmap, set(groups), kbt=KBT, spec=spec, l2_values=[L2],
            n_folds=CV_FOLDS, rng=np.random.default_rng(CV_SEED),
        )[L2][0]
        return {
            "config #3 fit, coefficients": fit()._coefs,
            "FusedGBMap application": fused_map(forces, coords),
            "TLinearMap application": linear_map(forces),
            "CV cell (l2 1e3, mean of 5 folds)": torch.tensor([cell]),
        }

    off = outputs()
    gram, rows, _ = fit_problem(
        torch, np, coords, forces, cmap, groups, spec, torch.float64, site_grams_plain
    )

    def rel(got, ref):
        return float((got.double() - ref.double()).abs().max() / ref.double().abs().max())

    matmul = torch.backends.cuda.matmul
    matmul.allow_tf32 = True
    try:
        on = outputs()
        still_on = matmul.allow_tf32
        # the planted check: the same fit with every full-fp32 scope
        # bypassed (both of torch's switches out of the scope's reach)
        setter, real = torch.set_float32_matmul_precision, torch.backends.cuda.matmul
        torch.set_float32_matmul_precision = lambda precision: None
        torch.backends.cuda.matmul = types.SimpleNamespace(fp32_precision="tf32")
        try:
            bypassed = fit()._coefs
        finally:
            torch.set_float32_matmul_precision = setter
            torch.backends.cuda.matmul = real
        scope_on_us = scope_cost(full_fp32)
    finally:
        matmul.allow_tf32 = False
    scope_off_us = scope_cost(full_fp32)
    failed = []
    for name, ref in off.items():
        err = rel(on[name], ref)
        log(f"  TF32 on: {name} vs TF32 off: {err:.3e} of the largest entry "
            f"(limit {TF32_REL_LIMIT:.0e}), bitwise equal {bool(torch.equal(on[name], ref))}")
        if not err <= TF32_REL_LIMIT:
            failed.append(f"with TF32 on, the {name} moved by {err:.3e}")
    gap, _ = objective_gap(
        np, gram.cpu().numpy(), rows.cpu().numpy(),
        on["config #3 fit, coefficients"].double().cpu().numpy(),
    )
    moved = rel(bypassed, off["config #3 fit, coefficients"])
    gap_bypassed, _ = objective_gap(
        np, gram.cpu().numpy(), rows.cpu().numpy(), bypassed.double().cpu().numpy()
    )
    log(f"  TF32 on: config #3 fit objective gap {gap:+.3e} (limit {J_GAP_LIMIT:.0e}); "
        f"switch still on afterwards: {still_on}; planted: the fit with its scopes "
        f"bypassed moved by {moved:.3e} of the largest coefficient (must exceed "
        f"{TF32_REL_LIMIT:.0e}), objective gap {gap_bypassed:+.3e}")
    if not gap <= J_GAP_LIMIT:
        failed.append("with TF32 on, the config #3 fit misses the objective gate")
    if not still_on:
        failed.append("the featurized paths did not leave the TF32 switch on")
    if not moved > TF32_REL_LIMIT:
        failed.append("the TF32 check does not see a fit with its scopes bypassed")

    # the scope on a hot function: trjdot at config #1's application shape
    # (device-bound) and on 256 frames (launch-bound), scoped and unscoped in
    # turns, the least of five rounds of 200 calls
    factor = torch.as_tensor(linear_map.standard_matrix, dtype=torch.float32, device="cuda")
    for points in (forces.float(), forces[:256].float()):
        per_call = {"scoped": [], "unscoped": []}
        for _ in range(5):
            for name, fn in (("scoped", trjdot), ("unscoped", trjdot.__wrapped__)):
                fn(points, factor)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    fn(points, factor)
                torch.cuda.synchronize()
                per_call[name].append((time.perf_counter() - t0) / 200 * 1e6)
        log(f"  trjdot at config #1 width, T={points.shape[0]} (TF32 off, host clock, "
            f"least of 5 rounds of 200 calls): {min(per_call['scoped']):.2f} us per "
            f"call scoped, {min(per_call['unscoped']):.2f} us unscoped")
    log(f"  full_fp32 scope alone: {scope_off_us:.3f} us per entry and exit with "
        f"TF32 off, {scope_on_us:.3f} us with TF32 on (switch flipped and restored)")
    if failed:
        fail("; ".join(failed))


def scope_cost(full_fp32, n=20_000):
    """Host microseconds of one entry and exit of ``full_fp32()``, the least
    of five rounds of ``n``."""
    rounds = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            with full_fp32():
                pass
        rounds.append((time.perf_counter() - t0) / n * 1e6)
    return min(rounds)


def generic_problem(torch, np, coords, forces, cmap, groups, spec, gram_fn, seed=7):
    """The generic path's per-site QPs in float64 on the card: the Gram of
    ``gram_fn`` over the frames (the canonical layout, which is the
    protocol path's feature layout) plus l2, and each site's constraint
    rows and targets on the 20 frames the protocol path draws for it from
    ``np.random.default_rng(seed)``, one site after another."""
    from aggforce_torch.qp.fusedfeat import (
        _assemble_constraint_system,
        _regularized,
        _site_gram,
        group_factorization,
    )

    geom = group_factorization(cmap, spec, set(groups))

    def dev(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float64, device="cuda")

    xyz, frc = dev(coords), dev(forces)
    consts = tuple(dev(geom[k]) for k in ("group_mean", "onehot", "counts", "centers"))
    cmap_mat = dev(cmap.standard_matrix)
    mask = torch.ones(len(coords), dtype=torch.float64, device="cuda")
    gram = _regularized(
        _site_gram(xyz, frc, mask, cmap_mat, *consts, KBT, spec, gram_fn), L2
    )
    rng = np.random.default_rng(seed)
    rows, targets = [], []
    for site in range(cmap.n_cg_sites):
        idx = torch.as_tensor(rng.choice(len(coords), size=20, replace=False), device="cuda")
        a_rows, b = _assemble_constraint_system(xyz[idx], cmap_mat, *consts, spec)
        rows.append(a_rows[site])
        targets.append(b[site])
    return gram, torch.stack(rows), torch.stack(targets)


def divergence_checks(torch, np, coords, cmap, groups, spec):
    """gb_feat's autodiff divergences ("reorder", "basic") against the closed
    form on DIV_FRAMES frames at config #3 width, every cg atom constrained
    to a partner (the autodiff methods give NaN where an atom sits on its cg
    point, as the reference's do). Returns the seconds of each method."""
    from aggforce_torch import gb_feat

    cg_atoms = [int(np.flatnonzero(row)[0]) for row in cmap.standard_matrix]
    partnered = set(groups) | {
        frozenset((a, a + 1)) for a in cg_atoms if not any(a in g for g in groups)
    }
    sub = coords[:DIV_FRAMES]
    # "basic" takes one forward pass per coordinate of its batch: one frame
    # at a time keeps its (3N, N, K_exp) tangents near 0.4 GB
    batch = {"closed": None, "reorder": 16, "basic": 1}
    divs, secs = {}, {}
    for method in ("closed", "reorder", "basic"):
        t0 = time.perf_counter()
        out = gb_feat(
            sub, cmap, partnered, outer=OUTER, n_basis=N_BASIS, width=WIDTH,
            lazy=False, div_method=method, batch_size=batch[method],
        )
        divs[method] = np.stack(out["divs"])
        secs[method] = time.perf_counter() - t0
    failed = []
    for method in ("reorder", "basic"):
        d = np.abs(divs[method] - divs["closed"])
        excess = float((d - (DIV_ATOL + DIV_RTOL * np.abs(divs["closed"]))).max())
        finite = bool(np.isfinite(divs[method]).all())
        log(f"  gb_feat div_method={method!r} vs 'closed' ({DIV_FRAMES} frames, "
            f"{len(partnered)} pairs, {divs[method].shape}): max |diff| {d.max():.3e}, "
            f"largest excess over atol {DIV_ATOL:.0e} + rtol {DIV_RTOL:.0e} "
            f"{excess:+.3e}; finite {finite}; {secs[method]:.3f} s "
            f"(closed {secs['closed']:.3f} s)")
        if not finite or not excess <= 0.0:
            failed.append(f"div_method={method!r} disagrees with the closed form")
    if failed:
        fail("; ".join(failed))
    return secs


def phase_generic(torch, np, coords_np, forces_np, cmap, groups, spec, smi):
    """The generic featurizer path at config #3 width on GENERIC_FRAMES
    frames: ``qp_feat_linear_map(allow_fused=False)`` with the device and the
    host backends. Gates: each fit within J_GAP_LIMIT of the float64 optimum
    for the constraint values it meets (a fit on a Gram without the
    divergence term must not be), no Gram kernel launch, the map's
    application equal to the FusedGBMap of its coefficients, and gb_feat's
    autodiff divergences against the closed form."""
    from aggforce_torch import Curry, Multifeaturize, Trajectory, gb_feat, id_feat
    from aggforce_torch.ops.gram import site_grams_plain
    from aggforce_torch.qp import qp_feat_linear_map
    from aggforce_torch.qp.fusedfeat import FusedGBMap, group_factorization

    t_phase = time.perf_counter()
    coords, forces = coords_np[:GENERIC_FRAMES], forces_np[:GENERIC_FRAMES]
    featurizer = Multifeaturize(
        [id_feat, Curry(gb_feat, outer=OUTER, n_basis=N_BASIS, width=WIDTH)]
    )
    log(f"generic path: {GENERIC_FRAMES} frames (reduced from {N_FRAMES}: each "
        f"site's features are held on the host, "
        f"{GENERIC_FRAMES * cmap.n_fg_sites * 1160 * 4 / 1e9:.2f} GB per site)")
    fits, secs = {}, {}
    for backend in ("device", "host"):
        reset_counts()
        t0 = time.perf_counter()
        fits[backend] = qp_feat_linear_map(
            Trajectory(coords=coords, forces=forces), cmap, featurizer, KBT,
            constraints=set(groups), l2_regularization=L2, allow_fused=False,
            constraint_rng=np.random.default_rng(7), solver_args={"backend": backend},
        )
        torch.cuda.synchronize()
        secs[backend] = time.perf_counter() - t0
        read_counts(f"generic path, {backend} backend", 0)
        log(f"generic path, {backend} backend: {secs[backend]:.3f} s -> "
            f"{GENERIC_FRAMES / secs[backend]:.1f} frames/s ({smi})")
    gram, rows, b = generic_problem(
        torch, np, coords, forces, cmap, groups, spec, site_grams_plain
    )
    fault_gram = generic_problem(
        torch, np, coords, forces, cmap, groups, spec, without_divergence
    )[0]
    gram_h, rows_h = gram.cpu().numpy(), rows.cpu().numpy()
    coefs = {
        f"generic fit, {k} backend": np.stack(v.force_map.tags["coef_list"]).astype(np.float64)
        for k, v in fits.items()
    }
    coefs["planted fault: no divergence term"] = device_solve(fault_gram, rows, b)
    gaps = {}
    for name, c in coefs.items():
        gaps[name], _ = objective_gap(np, gram_h, rows_h, c)
        viol = float(np.abs(np.einsum("smn,sn->sm", rows_h, c) - b.cpu().numpy()).max())
        log(f"  {name}: objective gap to its float64 witness {gaps[name]:+.3e} "
            f"(limit {J_GAP_LIMIT:.0e}); constraint violation {viol:.2e}")
    failed = [
        f"{name} objective gap {g:.3e}" for name, g in gaps.items()
        if not name.startswith("planted") and not g <= J_GAP_LIMIT
    ]
    if not gaps["planted fault: no divergence term"] > J_GAP_LIMIT:
        failed.append("the objective gate does not reject the planted fault")

    geom = group_factorization(cmap, spec, set(groups))
    fused = FusedGBMap(
        coefs=coefs["generic fit, device backend"].astype(np.float32),
        cmap_mat=np.asarray(cmap.standard_matrix, dtype=np.float32),
        onehot=geom["onehot"], centers=geom["centers"], kbt=KBT, spec=spec,
        device="cuda",
    )
    sub = slice(0, DIV_FRAMES)
    _, generic = fits["device"].map_arrays(coords[sub], forces[sub])
    rel = float(np.abs(fused(forces[sub], coords[sub]) - generic).max() / np.abs(generic).max())
    log(f"  generic map applied to {DIV_FRAMES} frames (featurizer re-run, kbt on "
        f"the divergence) vs the FusedGBMap of its coefficients: {rel:.3e} of the "
        f"largest entry (limit {GENERIC_APPLY_LIMIT:.0e})")
    if not rel <= GENERIC_APPLY_LIMIT:
        failed.append("the generic map's application differs from the fused map's")
    if failed:
        fail("generic path: " + "; ".join(failed))
    divergence_checks(torch, np, coords_np, cmap, groups, spec)
    phase_s = time.perf_counter() - t_phase
    log(f"phase 10 (generic path) {phase_s:.1f} s")
    return secs


class SkippingStream:
    """A stream that drops one chunk: the planted fault of the streamed Gram
    gate."""

    def __init__(self, stream, skip):
        self._stream, self._skip = stream, skip
        self.chunk_size, self.n_sites = stream.chunk_size, stream.n_sites

    def chunks(self, frame_slice=None):
        for i, chunk in enumerate(self._stream.chunks(frame_slice)):
            if i != self._skip:
                yield chunk


def write_npy(np, tmpdir, name, coords, forces):
    """Save a card trajectory to two .npy files; returns their paths and
    the seconds it took."""
    import os

    t0 = time.perf_counter()
    paths = []
    for kind, x in (("coords", coords), ("forces", forces)):
        path = os.path.join(tmpdir, f"{name}_{kind}.npy")
        np.save(path, x.cpu().numpy())
        paths.append(path)
    return paths, time.perf_counter() - t0


def pinned_copy_rate(torch, shape):
    """Bytes per second of a plain pinned host -> card copy of one float32
    array of ``shape`` (CUDA events, 20 copies)."""
    host = torch.empty(shape, dtype=torch.float32, pin_memory=True)
    dev = torch.empty(shape, dtype=torch.float32, device="cuda")
    ms = cuda_ms(torch, lambda: dev.copy_(host, non_blocking=True), reps=20)
    return host.numel() * 4 / (ms / 1e3), ms


def phase_streamed_featurized(torch, np, cmap, groups, spec, smi, tmpdir):
    """The streamed featurized fit at config #3 width over STREAM_FRAMES
    frames read from .npy files in STREAM_CHUNK-frame chunks. Gates: one
    kernel-1 launch per chunk; the streamed Gram within STREAM_GRAM_LIMIT of
    the largest entry of the in-memory kernel Gram of the same frames and of
    a float64 sum (a stream that skips one chunk must not be); the fit within
    J_GAP_LIMIT of its float64 optimum; kernel 1 against its plain version at
    the chunk shapes. Returns (launches, kernel-1 report at the chunk shape,
    max abs error, seconds of the streamed fit, seconds of its Gram, the fit's
    float64 problem (regularized Gram, constraint rows) on the host for
    phase 14); the launches are those the last streamed fit made, read after
    its counts were set to 0."""
    from aggforce_torch import Trajectory
    from aggforce_torch.io import TrajectoryStream, fused_gb_linear_map_streamed
    from aggforce_torch.io.stream import streamed_site_grams
    from aggforce_torch.ops.gram import site_grams, site_grams_plain, site_grams_tiled
    from aggforce_torch.qp.fusedfeat import (
        _assemble_constraint_system,
        _host_solve,
        _regularized,
        _site_gram,
        fused_gb_linear_map,
        group_factorization,
    )
    from aggforce_torch.utils.synth import synthesize_trajectory_device

    t_phase = time.perf_counter()
    base, _, _ = fixture_geometry()
    coords, forces = synthesize_trajectory_device(base, groups, STREAM_FRAMES, seed=2025)
    (cpath, fpath), write_s = write_npy(np, tmpdir, "config3", coords, forces)
    stream = TrajectoryStream.from_npy(cpath, fpath, chunk_size=STREAM_CHUNK)
    n_chunks = -(-STREAM_FRAMES // STREAM_CHUNK)
    n_bytes = 2 * coords.numel() * 4
    log(f"streamed fixture: {STREAM_FRAMES} frames x {cmap.n_fg_sites} atoms made on "
        f"the card and written to two .npy files ({n_bytes / 2e6:.1f} MB each) in "
        f"{write_s:.3f} s; {n_chunks} chunks of {STREAM_CHUNK} frames. The files sit "
        f"in the page cache, so the stream reads memory, not disk")
    kw = dict(kbt=KBT, spec=spec, constraints=set(groups), l2_regularization=L2)

    def streamed_fit():
        return fused_gb_linear_map_streamed(
            stream, cmap, constraint_rng=np.random.default_rng(7), **kw
        )

    fit_s = []
    for attempt in range(2):
        reset_counts()
        t0 = time.perf_counter()
        tmap = streamed_fit()
        torch.cuda.synchronize()
        fit_s.append(time.perf_counter() - t0)
        launches = site_grams.launches
        read = {"site_grams": launches, "site_grams_tiled": site_grams_tiled.launches}
        log(f"streamed featurized fit {attempt + 1}: {fit_s[-1]:.3f} s -> "
            f"{STREAM_FRAMES / fit_s[-1]:.1f} frames/s; launches {read} (must be "
            f"{n_chunks} and 0); solver_resid {tmap.force_map.tags['solver_resid']:.3e}, "
            f"escalated {tmap.force_map.tags['escalated']} ({smi})")
        if read != {"site_grams": n_chunks, "site_grams_tiled": 0}:
            fail(f"the streamed featurized fit launched {read}, not kernel 1 once "
                 f"per chunk ({n_chunks})")
    traj = Trajectory(coords=coords, forces=forces)
    mem_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        fused_gb_linear_map(traj, cmap, constraint_rng=np.random.default_rng(7), **kw)
        torch.cuda.synchronize()
        mem_s.append(time.perf_counter() - t0)
    log(f"in-memory fit of the same {STREAM_FRAMES} frames (trajectory on the card): "
        f"{mem_s[1]:.3f} s (first {mem_s[0]:.3f} s) -> "
        f"{STREAM_FRAMES / mem_s[1]:.1f} frames/s")

    # the Gram gate
    geom = group_factorization(cmap, spec, set(groups))
    names = ("group_mean", "onehot", "counts", "centers")
    cmap_np = np.asarray(cmap.standard_matrix)
    consts = tuple(
        torch.as_tensor(x, dtype=torch.float32, device="cuda")
        for x in (cmap_np, *(geom[k] for k in names))
    )
    consts64 = tuple(x.double() for x in consts)
    ones = torch.ones(STREAM_FRAMES, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streamed = streamed_site_grams(stream, consts, KBT, spec)
    torch.cuda.synchronize()
    gram_s = time.perf_counter() - t0
    in_memory = _site_gram(coords, forces, ones, *consts, KBT, spec, site_grams).double()
    exact = _site_gram(
        coords.double(), forces.double(), ones.double(), *consts64, KBT, spec,
        site_grams_plain,
    )
    skipped = streamed_site_grams(SkippingStream(stream, 3), consts, KBT, spec).double()
    peak = float(exact.abs().max())
    errs = {
        "streamed vs in-memory kernel Gram": float((streamed - in_memory).abs().max()) / peak,
        "streamed vs float64 sum": float((streamed - exact).abs().max()) / peak,
        "in-memory kernel Gram vs float64 sum": float((in_memory - exact).abs().max()) / peak,
        "planted fault (chunk 3 skipped) vs in-memory kernel Gram":
            float((skipped - in_memory).abs().max()) / peak,
    }
    for name, err in errs.items():
        log(f"  {name}: max abs diff / max entry {err:.3e} (limit {STREAM_GRAM_LIMIT:.0e})")
    failed = [
        name for name in ("streamed vs in-memory kernel Gram", "streamed vs float64 sum")
        if not errs[name] <= STREAM_GRAM_LIMIT
    ]
    if not errs["planted fault (chunk 3 skipped) vs in-memory kernel Gram"] > STREAM_GRAM_LIMIT:
        failed.append("the Gram gate does not reject a stream that skips a chunk")

    # the objective gate, on the streamed fit's own constraint frames
    frame_idx = np.random.default_rng(7).choice(STREAM_FRAMES, size=20, replace=False)
    rows, b = _assemble_constraint_system(
        coords.double()[torch.as_tensor(frame_idx, device="cuda")], *consts64, spec
    )
    gram_h, rows_h = _regularized(exact, L2).cpu().numpy(), rows.cpu().numpy()
    gap, _ = objective_gap(
        np, gram_h, rows_h, np.stack(tmap.force_map.tags["coef_list"]).astype(np.float64)
    )
    log(f"  streamed fit: objective gap to its float64 witness {gap:+.3e} "
        f"(limit {J_GAP_LIMIT:.0e})")
    if not gap <= J_GAP_LIMIT:
        failed.append(f"the streamed fit's objective gap {gap:.3e}")
    # why the stream sums its chunk Grams in float64 (printed, not gated):
    # the same chunks' kernel Grams summed in float32, and the float64 host
    # solve (the escalation) of each sum against the optimum
    sums = {"float32": None, "float64": None}
    for lo in range(0, STREAM_FRAMES, STREAM_CHUNK):
        part = _site_gram(
            coords[lo:lo + STREAM_CHUNK], forces[lo:lo + STREAM_CHUNK],
            ones[lo:lo + STREAM_CHUNK], *consts, KBT, spec, site_grams,
        )
        for kind in sums:
            x = part if kind == "float32" else part.double()
            sums[kind] = x if sums[kind] is None else sums[kind] + x
    for kind, total in sums.items():
        err = float((total.double() - exact).abs().max()) / peak
        coefs_h, _ = _host_solve(_regularized(total.double(), L2), rows, b)
        sum_gap, _ = objective_gap(np, gram_h, rows_h, coefs_h.astype(np.float64))
        log(f"  the {len(range(0, STREAM_FRAMES, STREAM_CHUNK))} chunk Grams summed in "
            f"{kind}: {err:.3e} of the largest entry from the float64 sum; its float64 "
            f"host solve {sum_gap:+.3e} above the optimum")
    del streamed, in_memory, exact, skipped, rows, sums
    if failed:
        fail("streamed featurized fit: " + "; ".join(failed))

    # kernel 1 at the stream's chunk shapes, against its plain version
    tail = STREAM_FRAMES - (n_chunks - 1) * STREAM_CHUNK
    ops = packed_operands(
        torch, coords[:STREAM_CHUNK], forces[:STREAM_CHUNK], cmap, groups, spec
    )
    errs_k = [
        compare_kernel(torch, ops, spec.n_basis, f"streamed chunk, T={STREAM_CHUNK}"),
        compare_kernel(
            torch, packed_operands(torch, coords[-tail:], forces[-tail:], cmap, groups, spec),
            spec.n_basis, f"streamed last chunk, T={tail}",
        ),
    ]
    report = gram_kernel_times(
        torch, ops, spec.n_basis, f"site_grams at the streamed chunk shape (T={STREAM_CHUNK})"
    )
    rate, copy_ms = pinned_copy_rate(torch, (STREAM_CHUNK, cmap.n_fg_sites, 3))
    transfer_s = n_bytes / rate
    kernel_s = n_chunks * report["ms"] / 1e3
    best = min(fit_s)
    bound_s = max(transfer_s, kernel_s)
    log(f"streamed fit against its bounds: bytes moved host -> card "
        f"{n_bytes / 1e6:.1f} MB; pinned copy of one {STREAM_CHUNK}-frame array "
        f"{copy_ms:.3f} ms -> {rate / 1e9:.2f} GB/s, so the transfers take "
        f"{transfer_s:.3f} s; {n_chunks} x kernel 1 at the chunk shape "
        f"{kernel_s:.3f} s. The streamed Gram alone (streamed_site_grams) "
        f"{gram_s:.3f} s -> {STREAM_FRAMES / gram_s:.1f} frames/s, "
        f"{gram_s / bound_s:.2f}x max(transfer, kernels); the whole fit "
        f"{best:.3f} s, {best / bound_s:.2f}x ({smi})")
    fit_breakdown(torch, streamed_fit, best)
    log(f"phase 11 (streamed featurized fit) {time.perf_counter() - t_phase:.1f} s; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del coords, forces, traj, ops
    return launches, report, max(errs_k), best, gram_s, (gram_h, rows_h)


def phase_streamed_linear(torch, np, smi, tmpdir):
    """The streamed linear fit at the linear sweep width over
    LINEAR_STREAM_FRAMES frames read from .npy files. Gates: the map within
    LINEAR_STREAM_ATOL of the in-memory ``qp_linear_map`` of the same frames,
    the mapped forces of SWEEP_CHECK_FRAMES frames within
    SWEEP_REL_RMS_LIMIT of a float64 witness (a fit without constraints must
    not be), and no Gram kernel launch."""
    from aggforce_torch import Trajectory
    from aggforce_torch.io import TrajectoryStream, qp_linear_map_streamed
    from aggforce_torch.qp import qp_linear_map

    t_phase = time.perf_counter()
    coords, forces, cmap, groups = linear_sweep_fixture(torch, LINEAR_STREAM_FRAMES, seed=2)
    (cpath, fpath), write_s = write_npy(np, tmpdir, "linear", coords, forces)
    stream = TrajectoryStream.from_npy(cpath, fpath, chunk_size=STREAM_CHUNK)
    log(f"streamed linear fixture: {LINEAR_STREAM_FRAMES} frames x {cmap.n_fg_sites} "
        f"atoms written to .npy ({forces.numel() * 4 / 1e6:.1f} MB per array) in "
        f"{write_s:.3f} s (page cache)")
    fit_s = []
    for attempt in range(2):
        reset_counts()
        t0 = time.perf_counter()
        smap = qp_linear_map_streamed(stream, cmap, constraints=set(groups))
        torch.cuda.synchronize()
        fit_s.append(time.perf_counter() - t0)
        read_counts(f"streamed linear fit {attempt + 1}", 0)
    reset_counts()
    traj = Trajectory(coords=coords, forces=forces)
    t0 = time.perf_counter()
    mmap = qp_linear_map(traj, cmap, constraints=set(groups))
    torch.cuda.synchronize()
    mem_s = time.perf_counter() - t0
    read_counts("in-memory linear fit of the same frames", 0)
    diff = float(np.abs(
        smap.force_map.standard_matrix - mmap.force_map.standard_matrix
    ).max())
    log(f"streamed linear fit: {fit_s[1]:.3f} s (first {fit_s[0]:.3f} s) -> "
        f"{LINEAR_STREAM_FRAMES / fit_s[1]:.1f} frames/s; in-memory fit {mem_s:.3f} s; "
        f"max |F_streamed - F_in_memory| {diff:.3e} (limit {LINEAR_STREAM_ATOL:.0e}) ({smi})")
    fault = qp_linear_map_streamed(stream, cmap, constraints=set())
    witness = sweep_witness(torch, np, forces, cmap, set(groups))
    head = forces[:SWEEP_CHECK_FRAMES]
    expect = torch.einsum("sn,tnd->tsd", witness, head.double())
    errs = {}
    for name, tm in (("streamed fit", smap), ("planted fault: constraints=set()", fault)):
        errs[name] = rel_rms(torch, tm.force_map(head), expect)
        log(f"  {name}: mapped forces of {SWEEP_CHECK_FRAMES} frames vs the float64 "
            f"witness, rel RMS {errs[name]:.3e} (limit {SWEEP_REL_RMS_LIMIT:.0e})")
    failed = []
    if not diff <= LINEAR_STREAM_ATOL:
        failed.append("the streamed map is off the in-memory map")
    if not errs["streamed fit"] <= SWEEP_REL_RMS_LIMIT:
        failed.append("the streamed fit misses the float64 witness")
    if not errs["planted fault: constraints=set()"] > SWEEP_REL_RMS_LIMIT:
        failed.append("the witness gate does not reject the planted fault")
    if failed:
        fail("streamed linear fit: " + "; ".join(failed))
    log(f"phase 12 (streamed linear fit) {time.perf_counter() - t_phase:.1f} s")
    return fit_s[1]


def staging_checks(torch, np, coords, forces, smi):
    """``stage_trajectory`` of phase 4's fixture: float32 bit-exact, float16
    within STAGE_F16_LIMIT of each value at half the bytes."""
    from aggforce_torch.io import stage_trajectory

    chunk_bytes = 4 << 20
    failed = []
    for wire in ("float32", "float16"):
        traj, report = stage_trajectory(coords, forces, wire_dtype=wire, chunk_bytes=chunk_bytes)
        itemsize = 4 if wire == "float32" else 2
        rows = max(1, chunk_bytes // (coords.shape[1] * 3 * itemsize))
        sizes = [
            min(rows, len(coords) - lo) * coords.shape[1] * 3 * itemsize
            for _ in range(2) for lo in range(0, len(coords), rows)
        ]
        mbps = [b / s / 1e6 for b, s in zip(sizes, report.chunk_seconds)]
        if wire == "float32":
            exact = all(
                torch.equal(x.cpu(), torch.as_tensor(y))
                for x, y in ((traj.coords, coords), (traj.forces, forces))
            )
            ok, detail = exact, f"bit-exact {exact}"
        else:
            rel = max(
                float((np.abs(x.cpu().numpy() - y) / np.maximum(np.abs(y), 1e-3)).max())
                for x, y in ((traj.coords, coords), (traj.forces, forces))
            )
            ok = rel < STAGE_F16_LIMIT and report.bytes == coords.nbytes
            detail = f"largest relative error {rel:.3e} (limit {STAGE_F16_LIMIT:.0e})"
        log(f"  stage_trajectory wire {wire}: {report.bytes / 1e6:.1f} MB in "
            f"{report.n_chunks} chunks, {report.seconds * 1e3:.2f} ms, "
            f"{report.mbps:.1f} MB/s overall; MB/s per chunk "
            f"{', '.join(f'{x:.0f}' for x in mbps)}; degraded {report.degraded}; "
            f"{detail} ({smi})")
        if not ok:
            failed.append(f"staging over the {wire} wire")
    return failed


def persistence_checks(torch, np, coords, forces, cmap, groups, spec, tmpdir):
    """save_tmap/load_tmap of a config-#3 FusedGBMap fit and a config-#1 map
    on the card: the loaded maps apply to the same forces."""
    import os

    from aggforce_torch import Trajectory
    from aggforce_torch.qp import qp_linear_map
    from aggforce_torch.qp.fusedfeat import fused_gb_linear_map
    from aggforce_torch.utils.serialize import load_tmap, save_tmap

    traj = Trajectory(
        coords=torch.as_tensor(coords, device="cuda"),
        forces=torch.as_tensor(forces, device="cuda"),
    )
    maps = {
        "config #3 FusedGBMap": fused_gb_linear_map(
            traj, cmap, kbt=KBT, spec=spec, constraints=set(groups),
            l2_regularization=L2, constraint_rng=np.random.default_rng(7),
        ),
        "config #1 TLinearMap": qp_linear_map(traj, cmap, constraints=set(groups)),
    }
    failed = []
    for name, tmap in maps.items():
        path = os.path.join(tmpdir, "map.npz")
        t0 = time.perf_counter()
        save_tmap(path, tmap)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = load_tmap(path)
        load_s = time.perf_counter() - t0
        before = tmap(traj).forces
        after = loaded(traj).forces
        rel = float((after - before).abs().max() / before.abs().max())
        log(f"  save_tmap/load_tmap {name}: {os.path.getsize(path)} bytes, save "
            f"{save_s * 1e3:.1f} ms, load {load_s * 1e3:.1f} ms; mapped forces of "
            f"{len(coords)} frames after the round trip {rel:.3e} of the largest "
            f"entry (limit {SERIALIZE_REL_LIMIT:.0e}); loaded on {after.device}")
        if not rel <= SERIALIZE_REL_LIMIT or after.device.type != "cuda":
            failed.append(f"the {name} round trip")
    return failed


def warmup_child(mode, build_dir):
    """One fresh process's first config-#3 fit, with or without
    ``warm_featurized_fit`` overlapping a WARMUP_SLEEP_S host sleep and the
    fixture's synthesis (the loading); the kernels build into the empty
    ``build_dir``. Prints one JSON line."""
    import numpy as np
    import torch

    from aggforce_torch import Trajectory
    from aggforce_torch.ops import _build
    from aggforce_torch.ops.gram import site_grams
    from aggforce_torch.qp.fusedfeat import GBFeatSpec, fused_gb_linear_map
    from aggforce_torch.utils.cache import enable_compile_cache
    from aggforce_torch.utils.warmup import warm_featurized_fit

    if not torch.cuda.is_available():
        fail("the warm-up subprocess has no CUDA card")
    enable_compile_cache(build_dir)
    _, groups, cmap = fixture_geometry()
    spec = GBFeatSpec(outer=OUTER, n_basis=N_BASIS, width=WIDTH)
    t0 = time.perf_counter()
    handle = None
    if mode == "with":
        handle = warm_featurized_fit(
            N_FRAMES, cmap, spec, set(groups), kbt=KBT, l2_regularization=L2
        )
    time.sleep(WARMUP_SLEEP_S)
    coords, forces, _, _ = fixture()
    load_s = time.perf_counter() - t0
    wait_s = handle.wait() if handle is not None else 0.0
    t1 = time.perf_counter()
    fused_gb_linear_map(
        Trajectory(coords=coords, forces=forces), cmap, kbt=KBT, spec=spec,
        constraints=set(groups), l2_regularization=L2,
        constraint_rng=np.random.default_rng(7),
    )
    torch.cuda.synchronize()
    done = time.perf_counter()
    print(json.dumps({
        "mode": mode, "load_s": load_s, "wait_s": wait_s, "first_fit_s": done - t1,
        "to_map_s": done - t0, "build_s": _build.last_build["seconds"],
        "warmup_phases": handle.phases if handle is not None else {},
        "warmup_error": repr(handle.error) if handle is not None and handle.error else None,
        "site_grams_launches": site_grams.launches,
    }))
    return 0


def warmup_checks(tmpdir):
    """The first config-#3 fit in two fresh subprocesses, each building the
    kernels into its own empty directory: without and with the warm-up."""
    import os

    out = {}
    failed = []
    for mode in ("without", "with"):
        build_dir = os.path.join(tmpdir, f"build_{mode}")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--warmup-child", mode, build_dir],
            capture_output=True, text=True, timeout=600,
        )
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            failed.append(f"the warm-up subprocess ({mode}) failed: {proc.stderr[-2000:]}")
            continue
        res = json.loads(lines[-1])
        out[mode] = res
        log(f"  fresh process {mode} warm_featurized_fit: first config-#3 fit "
            f"{res['first_fit_s']:.3f} s after {res['load_s']:.3f} s of loading "
            f"(a {WARMUP_SLEEP_S:.0f} s sleep and the fixture) and a "
            f"{res['wait_s']:.3f} s wait for the warm-up; loading to fitted map "
            f"{res['to_map_s']:.3f} s; nvcc (_build.last_build) {res['build_s']:.3f} s; "
            f"warm-up phases {res['warmup_phases']}; process wall {wall:.1f} s")
        if res["warmup_error"] or res["site_grams_launches"] < 1:
            failed.append(f"the {mode} process: {res}")
    if len(out) == 2:
        log(f"  warm-up saves {out['without']['first_fit_s'] - out['with']['first_fit_s']:.3f} s "
            f"of the first fit and {out['without']['to_map_s'] - out['with']['to_map_s']:.3f} s "
            f"from loading to fitted map")
    return failed, out


def phase_staging_persistence_warmup(torch, np, coords, forces, cmap, groups, spec, smi, tmpdir):
    """Staging, map persistence and the warm-up (phase 13)."""
    t_phase = time.perf_counter()
    failed = staging_checks(torch, np, coords, forces, smi)
    failed += persistence_checks(torch, np, coords, forces, cmap, groups, spec, tmpdir)
    warm_failed, warm = warmup_checks(tmpdir)
    failed += warm_failed
    if failed:
        fail("phase 13: " + "; ".join(failed))
    log(f"phase 13 (staging, persistence, warm-up) {time.perf_counter() - t_phase:.1f} s")
    return warm


# --- phase 14, the mesh -------------------------------------------------------


def timed_all_reduces(torch, mesh):
    """Time this mesh's all-reduces: ``mesh.all_reduce`` is wrapped so that
    each call waits for the device and a barrier of the ranks before it (the
    time is the collective's, not the wait for a slower rank) and for the
    device after it. Returns the list each call appends (bytes, seconds) to."""
    import torch.distributed as dist

    record, inner = [], mesh.all_reduce

    def all_reduce(x, *args, **kw):
        torch.cuda.synchronize()
        dist.barrier(group=mesh.group)
        t0 = time.perf_counter()
        out = inner(x, *args, **kw)
        torch.cuda.synchronize()
        record.append((x.numel() * x.element_size(), time.perf_counter() - t0))
        return out

    mesh.all_reduce = all_reduce
    return record


def mesh_run(torch, label, fn, mesh, traffic):
    """One mesh fit, the Gram kernels' counts set to 0 just before it and
    read just after: (result, launches, seconds, peak device bytes, this
    fit's all-reduces as (bytes, seconds), from the ``traffic`` list that
    ``timed_all_reduces`` fills)."""
    from aggforce_torch.ops.gram import site_grams, site_grams_tiled

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    n_traffic = len(traffic)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"site_grams": site_grams.launches, "site_grams_tiled": site_grams_tiled.launches}
    peak = torch.cuda.max_memory_allocated()
    reduces = list(traffic[n_traffic:])
    timed = ", ".join(f"{b / 1e6:.3f} MB in {t * 1e3:.3f} ms" for b, t in reduces)
    log(f"  [{mesh.rank}/{mesh.size}] {label}: {seconds:.3f} s; launches {launches}; peak "
        f"device memory {peak / 2**30:.2f} GiB; all_reduces: {timed or 'none'}")
    return out, launches, seconds, peak, reduces


def mesh_expect_launches(label, got, want, failed):
    if got != want:
        failed.append(f"{label} launched {got}, not {want}")


def mesh_one_rank(torch, np, coords_np, forces_np, cmap, groups, spec, cv_table, sweep, tmpdir):
    """Phase 14 (a): every mesh entry point on a world-size-1 NCCL group in
    this process, each held bit for bit to the single-device result of the
    earlier phases (the same call without ``mesh``, or that phase's
    output); the group is destroyed at the end. Returns kernel-1 and
    kernel-2 launches by path."""
    import os

    import torch.distributed as dist

    import aggforce_torch
    from aggforce_torch import Curry, Multifeaturize, Trajectory, gb_feat, id_feat
    from aggforce_torch import parallel as par
    from aggforce_torch.io import (
        TrajectoryStream,
        fused_gb_linear_map_streamed,
        qp_linear_map_streamed,
    )
    from aggforce_torch.qp import (
        fused_gb_linear_map_batch,
        fused_gb_linear_map_blocked,
        qp_feat_linear_map,
        stagedjoptgauss_map,
    )
    from aggforce_torch.qp.cv import fused_gb_cv
    from aggforce_torch.utils.warmup import warm_featurized_fit

    t_phase = time.perf_counter()
    par.initialize_distributed()  # no cluster: a real world-size-1 group
    mesh = par.make_mesh()
    traffic = timed_all_reduces(torch, mesh)
    log(f"phase 14 (a): backend {dist.get_backend()}, {mesh}")
    coords = torch.as_tensor(coords_np, device="cuda")
    forces = torch.as_tensor(forces_np, device="cuda")
    traj = Trajectory(coords=coords, forces=forces)
    constraints = set(groups)
    kw = dict(kbt=KBT, spec=spec, constraints=constraints, l2_regularization=L2)
    failed, by_path = [], {}

    def same(label, single, meshed):
        equal = all(np.array_equal(a, b) for a, b in zip(single, meshed))
        worst = max(float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))
                    for a, b in zip(single, meshed))
        log(f"  {label}: mesh result equals the single-device one bit for bit: "
            f"{equal} (largest difference {worst:.3e})")
        if not equal:
            failed.append(f"{label} differs from its single-device result")

    def coefs(tmap):
        return [np.stack(tmap.force_map.tags["coef_list"])]

    try:
        label = "config #1 (project_forces, every default)"
        single = aggforce_torch.project_forces(coords, forces, cmap)
        out, got, *_ = mesh_run(torch, label, lambda: aggforce_torch.project_forces(
            coords, forces, cmap, mesh=mesh), mesh, traffic)
        same(label, [single["tmap"].force_map.standard_matrix],
             [out["tmap"].force_map.standard_matrix])
        mesh_expect_launches(label, got, {"site_grams": 0, "site_grams_tiled": 0}, failed)

        featurizer = Multifeaturize(
            [id_feat, Curry(gb_feat, outer=OUTER, n_basis=N_BASIS, width=WIDTH)]
        )

        def config3(**extra):
            return aggforce_torch.project_forces(
                coords_np, forces_np, cmap, constrained_inds=constraints,
                method=qp_feat_linear_map, featurizer=featurizer, kbt=KBT,
                l2_regularization=L2, constraint_rng=np.random.default_rng(7), **extra,
            )

        label = "config #3 fit (project_forces)"
        single = config3()
        out, got, *_ = mesh_run(torch, label, lambda: config3(mesh=mesh), mesh, traffic)
        same(label, coefs(single["tmap"]), coefs(out["tmap"]))
        mesh_expect_launches(label, got, {"site_grams": 1, "site_grams_tiled": 0}, failed)
        by_path[label] = got

        label = "batch fits (fused_gb_linear_map_batch)"
        seeds = list(range(BATCH_WINDOWS * BATCH_WINDOW))
        single = fused_gb_linear_map_batch(traj, cmap, seeds=seeds, flush_every=BATCH_WINDOW, **kw)
        out, got, *_ = mesh_run(torch, label, lambda: fused_gb_linear_map_batch(
            traj, cmap, seeds=seeds, flush_every=BATCH_WINDOW, mesh=mesh, **kw), mesh, traffic)
        same(label, [m.force_map._coefs.cpu().numpy() for m in single],
             [m.force_map._coefs.cpu().numpy() for m in out])
        mesh_expect_launches(
            label, got, {"site_grams": BATCH_WINDOWS, "site_grams_tiled": 0}, failed
        )
        by_path[label] = got
        del single, out

        label = "config #4 CV (fused_gb_cv)"
        out, got, *_ = mesh_run(torch, label, lambda: fused_gb_cv(
            coords, forces, cmap, constraints, kbt=KBT, spec=spec, l2_values=CV_L2S,
            n_folds=CV_FOLDS, n_constraint_frames=20, rng=np.random.default_rng(CV_SEED),
            mesh=mesh), mesh, traffic)
        same(label, [np.array(list(cv_table.values()), dtype=np.float64)],
             [np.array(list(out.values()), dtype=np.float64)])
        mesh_expect_launches(label, got, {"site_grams": CV_FOLDS, "site_grams_tiled": 0}, failed)
        by_path[label] = got

        label = "config #2 staged map (stagedjoptgauss_map)"

        def staged(**extra):
            tmap = stagedjoptgauss_map(
                traj, cmap, var=GAUSS_VAR, kbt=KBT, constraints=constraints,
                seed=GAUSS_SEEDS[0], **extra,
            )
            return [tmap[1].force_map.standard_matrix, tmap[0].tmap.force_map.standard_matrix]

        single = staged()
        out, got, *_ = mesh_run(torch, label, lambda: staged(mesh=mesh), mesh, traffic)
        same(label, single, out)
        mesh_expect_launches(label, got, {"site_grams": 0, "site_grams_tiled": 0}, failed)

        label = "streamed featurized fit (fused_gb_linear_map_streamed)"
        stream = TrajectoryStream.from_npy(
            os.path.join(tmpdir, "config3_coords.npy"), os.path.join(tmpdir, "config3_forces.npy"),
            chunk_size=STREAM_CHUNK,
        )

        def streamed(**extra):
            return fused_gb_linear_map_streamed(
                stream, cmap, constraint_rng=np.random.default_rng(7), **kw, **extra
            )

        single = streamed()
        out, got, *_ = mesh_run(torch, label, lambda: streamed(mesh=mesh), mesh, traffic)
        same(label, coefs(single), coefs(out))
        n_chunks = -(-STREAM_FRAMES // STREAM_CHUNK)
        mesh_expect_launches(label, got, {"site_grams": n_chunks, "site_grams_tiled": 0}, failed)
        by_path[label] = got

        label = "streamed linear fit (qp_linear_map_streamed)"
        _, _, lcmap, lgroups = linear_sweep_fixture(torch, 8, seed=2)
        lstream = TrajectoryStream.from_npy(
            os.path.join(tmpdir, "linear_coords.npy"), os.path.join(tmpdir, "linear_forces.npy"),
            chunk_size=STREAM_CHUNK,
        )
        single = qp_linear_map_streamed(lstream, lcmap, constraints=set(lgroups))
        out, got, *_ = mesh_run(torch, label, lambda: qp_linear_map_streamed(
            lstream, lcmap, constraints=set(lgroups), mesh=mesh), mesh, traffic)
        same(label, [single.force_map.standard_matrix], [out.force_map.standard_matrix])
        mesh_expect_launches(label, got, {"site_grams": 0, "site_grams_tiled": 0}, failed)

        label = "warm_featurized_fit"

        def warm():
            handle = warm_featurized_fit(
                N_FRAMES, cmap, spec, constraints, kbt=KBT, l2_regularization=L2, mesh=mesh
            )
            handle.wait()
            return handle

        handle, got, *_ = mesh_run(torch, label, warm, mesh, traffic)
        log(f"  {label}: phases {handle.phases}, error {handle.error!r}")
        if handle.error is not None:
            failed.append(f"the mesh warm-up failed: {handle.error!r}")
        mesh_expect_launches(label, got, {"site_grams": 1, "site_grams_tiled": 0}, failed)
        by_path[label] = got

        label = "sweep fit (fused_gb_linear_map_blocked)"
        out, got, *_ = mesh_run(torch, label, lambda: fused_gb_linear_map_blocked(
            sweep["traj"], sweep["cmap"], kbt=SWEEP_KBT, spec=sweep["spec"],
            constraints=set(sweep["groups"]), l2_regularization=L2, n_constraint_frames=20,
            constraint_rng=np.random.default_rng(3), chunk_size=256,
            site_block=SWEEP_SITE_BLOCK, mesh=mesh), mesh, traffic)
        same(label, [sweep["coefs"]], coefs(out))
        n_blocks = -(-sweep["cmap"].n_cg_sites // SWEEP_SITE_BLOCK)
        mesh_expect_launches(label, got, {"site_grams": 0, "site_grams_tiled": n_blocks}, failed)
        by_path[label] = got
        del out
    finally:
        dist.destroy_process_group()
    if failed:
        fail("phase 14 (a): " + "; ".join(failed))
    log(f"phase 14 (a) (one rank, NCCL) {time.perf_counter() - t_phase:.1f} s")
    return by_path


def shard_kernel_check(torch, args, label, checks):
    """Kernel 1 against its plain version on one of this rank's shards
    (``args``: a ``_site_gram`` argument list without its Gram function),
    the tolerance of ``compare_kernel``: atol 3e-4 * (max|plain| + 1).
    Appends the result to ``checks`` and returns the kernel's Gram."""
    from aggforce_torch.ops.gram import site_grams, site_grams_plain
    from aggforce_torch.qp.fusedfeat import _site_gram

    got = _site_gram(*args, site_grams)
    torch.cuda.synchronize()
    ref = _site_gram(*args, site_grams_plain)
    err = float((got - ref).abs().max())
    atol = 3e-4 * (float(ref.abs().max()) + 1.0)
    finite = bool(torch.isfinite(got).all())
    log(f"  site_grams vs plain [{label}] frames={args[0].shape[0]} "
        f"max_abs_err={err:.6g} atol={atol:.6g} finite={finite}")
    checks.append({"shape": label, "frames": int(args[0].shape[0]), "max_abs_err": err,
                   "atol": atol, "finite": finite})
    del ref
    return got


def mesh_child(rank, world, store):
    """Phase 14 (b)'s rank ``rank`` of ``world``: joins the gloo group on a
    FileStore at ``store`` (all ranks share the one card), runs the mesh
    fits, holds kernel 1 against its plain version on each of its shards,
    and writes its results beside ``store`` (``mesh_rank<rank>.npz`` and
    ``.json``); rank 0 adds the reduced and the unreduced (its own share)
    fold and streamed Grams."""
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    import aggforce_torch
    from aggforce_torch import Curry, Multifeaturize, Trajectory, gb_feat, id_feat
    from aggforce_torch import parallel as par
    from aggforce_torch.io import TrajectoryStream, fused_gb_linear_map_streamed
    from aggforce_torch.io.stream import streamed_site_grams
    from aggforce_torch.parallel.mesh import shard_frames
    from aggforce_torch.qp import (
        fused_gb_linear_map_batch,
        fused_gb_linear_map_blocked,
        make_bond_constraint_matrix,
        qp_feat_linear_map,
    )
    from aggforce_torch.qp.cv import _featurized_cv_problem, fused_gb_cv, linear_map_cv
    from aggforce_torch.qp.fusedfeat import GBFeatSpec, _fit_constants, _prepare_fused_setup
    from aggforce_torch.qp.qplinear import fit_routes

    if not torch.cuda.is_available():
        fail("the mesh child has no CUDA card")
    torch.cuda.set_device(0)
    tmpdir = os.path.dirname(store)
    par.initialize_distributed("file://" + store, world, rank, backend="gloo")
    mesh = par.make_mesh()
    traffic = timed_all_reduces(torch, mesh)
    coords, forces, cmap, groups = fixture()
    constraints = set(groups)
    spec = GBFeatSpec(outer=OUTER, n_basis=N_BASIS, width=WIDTH)
    res, meta = {}, {"launches": {}, "seconds": {}, "peak_bytes": {}, "all_reduce": {}}
    checks = meta["kernel_vs_plain"] = []

    def run(label, fn):
        out, launches, seconds, peak, reduces = mesh_run(torch, label, fn, mesh, traffic)
        meta["launches"][label] = launches
        meta["seconds"][label] = seconds
        meta["peak_bytes"][label] = peak
        meta["all_reduce"][label] = reduces
        return out

    def coefs(tmap):
        return np.stack(tmap.force_map.tags["coef_list"])

    featurizer = Multifeaturize(
        [id_feat, Curry(gb_feat, outer=OUTER, n_basis=N_BASIS, width=WIDTH)]
    )
    out = run("config #3 fit (project_forces)", lambda: aggforce_torch.project_forces(
        coords, forces, cmap, constrained_inds=constraints, method=qp_feat_linear_map,
        featurizer=featurizer, kbt=KBT, l2_regularization=L2,
        constraint_rng=np.random.default_rng(7), mesh=mesh))
    res["config3_coefs"] = coefs(out["tmap"])
    # the fit's reduced Gram, by its own steps: this rank's share of the
    # frames through the kernel (held against the plain version on the same
    # shard; the batch fits take the same shard), then the all-reduce
    setup = _prepare_fused_setup(
        Trajectory(coords=coords, forces=forces), cmap, spec, constraints, None, mesh
    )
    local = shard_kernel_check(
        torch, (*setup["trajectory"], *setup["consts"], KBT, spec), "config #3 shard", checks
    )
    res["config3_gram_local"] = local.cpu().numpy()
    res["config3_gram"] = mesh.all_reduce(local.clone()).cpu().numpy()
    del setup, local

    maps = run("batch fits (fused_gb_linear_map_batch)", lambda: fused_gb_linear_map_batch(
        Trajectory(coords=coords, forces=forces), cmap, kbt=KBT, spec=spec,
        seeds=range(MESH_BATCH_WINDOWS * BATCH_WINDOW), constraints=constraints,
        l2_regularization=L2, flush_every=BATCH_WINDOW, mesh=mesh))
    res["batch_coefs"] = torch.stack([m.force_map._coefs for m in maps]).cpu().numpy()
    del maps

    out = run("config #1 (project_forces, every default)", lambda: aggforce_torch.project_forces(
        coords, forces, cmap, mesh=mesh))
    res["config1_map"] = out["tmap"].force_map.standard_matrix
    res["sharded_linear_map"] = run("sharded_linear_fit", lambda: par.sharded_linear_fit(
        forces, make_bond_constraint_matrix(cmap.n_fg_sites, out["constraints"]),
        cmap.standard_matrix, mesh=mesh))
    table = run("config #1 linear CV (linear_map_cv)", lambda: linear_map_cv(
        coords, forces, cmap, out["constraints"], CV_L2S, n_folds=CV_FOLDS,
        rng=np.random.default_rng(CV_SEED), mesh=mesh))
    res["linear_cv"] = np.array([table[float(l2)][0] for l2 in CV_L2S])
    table = run("config #4 CV (fused_gb_cv)", lambda: fused_gb_cv(
        coords, forces, cmap, constraints, kbt=KBT, spec=spec, l2_values=CV_L2S,
        n_folds=CV_FOLDS, n_constraint_frames=20, rng=np.random.default_rng(CV_SEED),
        mesh=mesh))
    res["feat_cv"] = np.array([table[float(l2)][0] for l2 in CV_L2S])
    escalated = fit_routes.get("cv_escalated_cells", 0)
    # the CV's reduced problem, by its own steps, through phase 5's cell
    # gate (in this process: the cells must be the ones the CV solved)
    grams, rows, b_all, folds, _ = _featurized_cv_problem(
        coords, forces, cmap, constraints, KBT, spec, CV_FOLDS, 20,
        np.random.default_rng(CV_SEED), mesh=mesh,
    )
    if rank == 0:
        log(f"  [{rank}/{world}] the mesh CV against float64 witnesses of its reduced "
            f"fold Grams (phase 5's gate):")
        meta["cv_gate_failed"] = cv_cell_gate(
            torch, np, table, grams, rows, b_all, folds, escalated
        )["failed"]
    del rows, b_all
    # each fold's share on this rank, as the CV pads and splits it, through
    # the kernel and its plain version
    consts = _fit_constants(cmap, spec, constraints, mesh.device)["consts"]
    pad_len = -(-max(len(idx) for idx in folds) // world) * world
    local = torch.stack([
        shard_kernel_check(
            torch, (*shard_frames(mesh, [coords, forces], idx, length=pad_len),
                    *consts, KBT, spec), f"config #4 CV fold {f} shard", checks,
        )
        for f, idx in enumerate(folds)
    ])
    if rank == 0:  # the parent gates them against the single-device fold Grams
        res["cv_gram"] = grams.cpu().numpy()
        res["cv_gram_local"] = local.cpu().numpy()
    del grams, local

    stream = TrajectoryStream.from_npy(
        os.path.join(tmpdir, "config3_coords.npy"), os.path.join(tmpdir, "config3_forces.npy"),
        chunk_size=STREAM_CHUNK,
    )
    frame_slice = par.process_frame_slice(stream.n_frames)
    fit = run("streamed featurized fit (fused_gb_linear_map_streamed)",
              lambda: fused_gb_linear_map_streamed(
                  stream, cmap, kbt=KBT, spec=spec, constraints=constraints,
                  l2_regularization=L2, constraint_rng=np.random.default_rng(7), mesh=mesh,
                  frame_slice=frame_slice))
    res["stream_coefs"] = coefs(fit)
    # the streamed Gram by its own steps: this rank's frame_slice, then the
    # all-reduce; and kernel 1 on the slice's first and last chunks
    local = streamed_site_grams(stream, consts, KBT, spec, frame_slice)
    reduced = mesh.all_reduce(local.clone())
    if rank == 0:
        res["stream_gram"] = reduced.cpu().numpy()
        res["stream_gram_local"] = local.cpu().numpy()
    del local, reduced
    chunks = list(stream.chunks(frame_slice))
    for name, (cc, fc, n_valid) in (("first", chunks[0]), ("last", chunks[-1])):
        shard_kernel_check(
            torch, (torch.as_tensor(np.asarray(cc), device="cuda"),
                    torch.as_tensor(np.asarray(fc), device="cuda"),
                    torch.ones(n_valid, dtype=torch.float32, device="cuda"),
                    *consts, KBT, spec), f"streamed {name} chunk of the rank's slice",
            checks,
        )
    del chunks

    t0 = time.perf_counter()
    scoords, sforces, scmap, sgroups = sweep_fixture()
    straj = Trajectory(coords=torch.as_tensor(scoords, device="cuda"),
                       forces=torch.as_tensor(sforces, device="cuda"))
    del scoords, sforces
    log(f"  [{rank}/{world}] sweep fixture {time.perf_counter() - t0:.3f} s")
    fit = run("sweep fit (fused_gb_linear_map_blocked)", lambda: fused_gb_linear_map_blocked(
        straj, scmap, kbt=SWEEP_KBT, spec=GBFeatSpec(outer=8.0, inner=0.0, n_basis=7, width=1.0),
        constraints=set(sgroups), l2_regularization=L2, n_constraint_frames=20,
        constraint_rng=np.random.default_rng(3), chunk_size=256,
        site_block=SWEEP_SITE_BLOCK, mesh=mesh))
    res["sweep_coefs"] = coefs(fit)
    dist.destroy_process_group()
    np.savez(os.path.join(tmpdir, f"mesh_rank{rank}.npz"), **res)
    with open(os.path.join(tmpdir, f"mesh_rank{rank}.json"), "w") as fh:
        json.dump(meta, fh)
    log(f"  [{rank}/{world}] done, group destroyed: {not dist.is_initialized()}")
    return 0


def mesh_two_ranks(torch, np, coords_np, forces_np, cmap, groups, spec, problem64, cv_table,
                   sweep, stream64, tmpdir, smi):
    """Phase 14 (b): two ranks sharing the one card over gloo
    (``--mesh-child`` subprocesses, a FileStore in ``tmpdir``). Gates: the
    ranks' results equal bit for bit; kernel 1 against its plain version on
    every shard a rank launched it on; rank 0's reduced Grams (config #3,
    the config-#4 CV's folds, the streamed fit's) within MESH_GRAM_LIMIT of
    the largest entry of their single-device Grams (rank 0's own share, a
    Gram missing rank 1's frames, must not be); the config-#3 fit, two
    batch fits, the streamed fit and two sweep blocks (one per rank) within
    J_GAP_LIMIT of their float64 optimum; config #1's mapped forces within
    CONFIG1_REL_RMS_LIMIT of the float64 host fit; the CV's cells through
    phase 5's gate (``cv_cell_gate``, run by rank 0 on its reduced fold
    Grams). Returns each rank's launches by path and kernel 1's largest
    error against its plain version on the ranks' shards, by shard."""
    import os

    from aggforce_torch import Trajectory, qp_linear_map
    from aggforce_torch.io import TrajectoryStream
    from aggforce_torch.io.stream import streamed_site_grams
    from aggforce_torch.ops.gram import site_grams, site_grams_plain
    from aggforce_torch.qp.cv import _featurized_cv_problem
    from aggforce_torch.qp.fusedfeat import _fit_constants, _prepare_fused_setup, _site_gram

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # the children share the card: give back the cached blocks
    store = os.path.join(tmpdir, "mesh_store")
    # a share of the host's cores each: the children's float64 host solves
    # (the CV's escalated cells) would otherwise wait on each other's threads
    threads = str(max(1, (os.cpu_count() or MESH_WORLD) // MESH_WORLD))
    env = dict(os.environ, OMP_NUM_THREADS=threads, OPENBLAS_NUM_THREADS=threads)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-child", str(rank),
             str(MESH_WORLD), store],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for rank in range(MESH_WORLD)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MESH_CHILD_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        fail(f"phase 14 (b): a mesh child outlived {MESH_CHILD_TIMEOUT_S} s: " + " | ".join(
            (p.communicate()[0] or "")[-2000:] for p in procs))
    for rank, (p, out) in enumerate(zip(procs, outs)):
        for line in out.strip().splitlines():
            print(f"    rank {rank}: {line}", flush=True)
        if p.returncode != 0:
            fail(f"phase 14 (b): the rank {rank} child exited {p.returncode}")
    res = [dict(np.load(os.path.join(tmpdir, f"mesh_rank{r}.npz"))) for r in range(MESH_WORLD)]
    meta = []
    for r in range(MESH_WORLD):
        with open(os.path.join(tmpdir, f"mesh_rank{r}.json")) as fh:
            meta.append(json.load(fh))
    log(f"phase 14 (b): {MESH_WORLD} ranks sharing one card over gloo; children "
        f"{time.perf_counter() - t_phase:.1f} s ({smi}). Two ranks on one card "
        f"measure correctness and the collectives' cost, not scaling; NCCL across "
        f"cards is not measured")
    for label in meta[0]["seconds"]:
        per_rank = "; ".join(
            f"rank {r}: {m['seconds'][label]:.3f} s, peak {m['peak_bytes'][label] / 2**30:.2f} GiB, "
            f"all_reduce " + (", ".join(f"{b / 1e6:.3f} MB in {t * 1e3:.3f} ms"
                                        for b, t in m["all_reduce"][label]) or "none")
            for r, m in enumerate(meta)
        )
        log(f"  {label}: {per_rank}")

    failed = []
    # every result both ranks wrote but each rank's own Gram share, which
    # differs by design
    shared = [k for k in res[0] if k in res[1] and not k.endswith("_local")]
    for key in shared:
        if not np.array_equal(res[0][key], res[1][key]):
            failed.append(f"the ranks' {key} differ")
    log(f"  ranks equal bit for bit: {shared}{' except ' + ', '.join(failed) if failed else ''}")
    n_stream = -(-(-(-STREAM_FRAMES // MESH_WORLD)) // STREAM_CHUNK)
    n_sweep_steps = -(-sweep["cmap"].n_cg_sites // (SWEEP_SITE_BLOCK * MESH_WORLD))
    want = {
        "config #3 fit (project_forces)": (1, 0),
        "batch fits (fused_gb_linear_map_batch)": (MESH_BATCH_WINDOWS, 0),
        "config #1 (project_forces, every default)": (0, 0),
        "sharded_linear_fit": (0, 0),
        "config #1 linear CV (linear_map_cv)": (0, 0),
        "config #4 CV (fused_gb_cv)": (CV_FOLDS, 0),
        "streamed featurized fit (fused_gb_linear_map_streamed)": (n_stream, 0),
        "sweep fit (fused_gb_linear_map_blocked)": (0, n_sweep_steps),
    }
    for r, m in enumerate(meta):
        for label, (k1, k2) in want.items():
            got = m["launches"][label]
            if got != {"site_grams": k1, "site_grams_tiled": k2}:
                failed.append(f"rank {r}'s {label} launched {got}, not ({k1}, {k2})")

    # kernel 1 against its plain version on each rank's shards
    shard_err = {}
    for r, m in enumerate(meta):
        for c in m["kernel_vs_plain"]:
            key = f"{c['shape']} ({c['frames']} frames)"
            shard_err[key] = max(shard_err.get(key, 0.0), c["max_abs_err"])
            if not c["finite"] or not c["max_abs_err"] <= c["atol"]:
                failed.append(f"rank {r}: site_grams disagrees with its plain version at "
                              f"{key}: {c['max_abs_err']:.6g} > {c['atol']:.6g}")
    log(f"  kernel 1 vs plain on the ranks' shards: {len(meta[0]['kernel_vs_plain'])} shards "
        f"per rank, largest max_abs_err by shard {shard_err}")

    # rank 0's reduced Grams against the single-device Grams
    setup = _prepare_fused_setup(
        Trajectory(coords=coords_np, forces=forces_np), cmap, spec, set(groups), "cuda"
    )
    singles = {
        "config3": _site_gram(
            *setup["trajectory"], *setup["consts"], KBT, spec, site_grams
        ).cpu().numpy(),
        "cv": _featurized_cv_problem(
            coords_np, forces_np, cmap, set(groups), KBT, spec, CV_FOLDS, 20,
            np.random.default_rng(CV_SEED), device="cuda",
        )[0].cpu().numpy(),
        "stream": streamed_site_grams(
            TrajectoryStream.from_npy(
                os.path.join(tmpdir, "config3_coords.npy"),
                os.path.join(tmpdir, "config3_forces.npy"), chunk_size=STREAM_CHUNK,
            ),
            _fit_constants(cmap, spec, set(groups), torch.device("cuda"))["consts"], KBT, spec,
        ).cpu().numpy(),
    }
    del setup
    names = {"config3": "config-#3 Gram", "cv": "config-#4 CV fold Grams",
             "stream": "streamed Gram"}
    for key, full in singles.items():
        scale = float(np.abs(full).max())
        err = float(np.abs(res[0][f"{key}_gram"] - full).max()) / scale
        fault = float(np.abs(res[0][f"{key}_gram_local"] - full).max()) / scale
        log(f"  reduced {names[key]} vs the single-device one: max abs err / max entry "
            f"{err:.3e}; planted fault, rank 0's share alone: {fault:.3e} (limit "
            f"{MESH_GRAM_LIMIT:.0e})")
        if not err <= MESH_GRAM_LIMIT:
            failed.append(f"the reduced {names[key]} misses the single-device one")
        if not fault > MESH_GRAM_LIMIT:
            failed.append(f"the {names[key]} gate does not reject a Gram missing rank 1's share")
    del singles, full

    # objectives against float64 optima
    gram64, rows64 = problem64
    gap, _ = objective_gap(np, gram64, rows64, res[0]["config3_coefs"].astype(np.float64))
    log(f"  config #3 mesh fit: objective gap to its float64 witness {gap:+.3e} "
        f"(limit {J_GAP_LIMIT:.0e})")
    if not gap <= J_GAP_LIMIT:
        failed.append("the config-#3 mesh fit misses its float64 optimum")
    del gram64, rows64
    coords, forces = (torch.as_tensor(x, device="cuda") for x in (coords_np, forces_np))
    for seed in (0, MESH_BATCH_WINDOWS * BATCH_WINDOW - 1):
        gram, rows, _ = fit_problem(
            torch, np, coords, forces, cmap, groups, spec, torch.float64,
            site_grams_plain, seed=seed,
        )
        gap, _ = objective_gap(np, gram.cpu().numpy(), rows.cpu().numpy(),
                               res[0]["batch_coefs"][seed].astype(np.float64))
        log(f"  batch mesh fit, seed {seed}: objective gap {gap:+.3e} (limit {J_GAP_LIMIT:.0e})")
        if not gap <= J_GAP_LIMIT:
            failed.append(f"the batch mesh fit of seed {seed} misses its float64 optimum")
    del gram, rows
    for first in (0, SWEEP_SITE_BLOCK):  # rank 0's first block, rank 1's first block
        try:
            sweep_block_gate(
                torch, np, sweep["traj"].coords, sweep["traj"].forces, sweep["cmap"],
                sweep["groups"], sweep["spec"], res[0]["sweep_coefs"], first_site=first,
            )
        except RuntimeError as err:
            failed.append(f"sweep block at site {first}: {err}")

    # config #1 against the float64 host fit
    host = qp_linear_map(
        Trajectory(coords=coords_np, forces=forces_np.astype(np.float64)), cmap,
        constraints=set(groups), solver_args={"backend": "host"},
    ).force_map.standard_matrix
    expect = np.einsum("sn,tnd->tsd", host, forces_np.astype(np.float64))
    for key in ("config1_map", "sharded_linear_map"):
        got = np.einsum("sn,tnd->tsd", res[0][key].astype(np.float64), forces_np)
        err = float(np.sqrt(np.mean((got - expect) ** 2) / np.mean(expect**2)))
        log(f"  {key}: mapped forces vs the float64 host fit, rel RMS {err:.3e} "
            f"(limit {CONFIG1_REL_RMS_LIMIT:.0e})")
        if not err <= CONFIG1_REL_RMS_LIMIT:
            failed.append(f"{key} misses the float64 host fit")

    # the CVs
    exact = linear_cv_float64(torch, np, forces, cmap, groups)
    rel = np.abs(res[0]["linear_cv"] - exact) / exact
    log(f"  config #1 linear CV: largest rel err against float64 scores {rel.max():.3e} "
        f"(limit {CV_REL_LIMIT:.0e})")
    if not rel.max() <= CV_REL_LIMIT:
        failed.append("the mesh linear CV misses the float64 scores")
    failed += [f"the mesh CV: {f}" for f in meta[0]["cv_gate_failed"]]
    for i, l2 in enumerate(CV_L2S):
        ref = cv_table[float(l2)][0]
        log(f"  config #4 CV l2 {l2:g}: mesh {res[0]['feat_cv'][i]:.8g}, single-device "
            f"{ref:.8g} (rel {abs(res[0]['feat_cv'][i] - ref) / abs(ref):.3e})")
    gap, _ = objective_gap(np, *stream64, res[0]["stream_coefs"].astype(np.float64))
    log(f"  streamed mesh fit: objective gap to phase 11's float64 witness {gap:+.3e} "
        f"(limit {J_GAP_LIMIT:.0e})")
    if not gap <= J_GAP_LIMIT:
        failed.append("the streamed mesh fit misses its float64 optimum")
    if failed:
        fail("phase 14 (b): " + "; ".join(failed))
    log(f"phase 14 (b) (two ranks, gloo) {time.perf_counter() - t_phase:.1f} s")
    return [m["launches"] for m in meta], shard_err


def phase_mesh(torch, np, coords, forces, cmap, groups, spec, problem64, cv_table, sweep,
               stream64, tmpdir, smi):
    """Phase 14: (a) every mesh entry point on one NCCL rank, (b) two gloo
    ranks sharing the card, and kernel 1's times at the per-rank shard
    shape; its report carries the largest error against the plain version
    on the ranks' shards (``max_abs_err``, and by shard)."""
    t_phase = time.perf_counter()
    one = mesh_one_rank(torch, np, coords, forces, cmap, groups, spec, cv_table, sweep, tmpdir)
    two, shard_err = mesh_two_ranks(
        torch, np, coords, forces, cmap, groups, spec, problem64, cv_table, sweep, stream64,
        tmpdir, smi,
    )
    shard = N_FRAMES // MESH_WORLD
    shard_times = {
        **gram_kernel_times(
            torch, packed_operands(torch, coords[:shard], forces[:shard], cmap, groups, spec),
            spec.n_basis, f"site_grams at the mesh shard shape ({shard} frames)",
        ),
        "max_abs_err": max(shard_err.values()),
        "max_abs_err_by_shard": shard_err,
    }
    log(f"phase 14 (mesh) {time.perf_counter() - t_phase:.1f} s ({smi})")
    return one, two, shard_times


# --- phase 15, the example twins ----------------------------------------------

# the JAX examples' own sizes: 2,000 frames (gauss, production_fit, cv_feat),
# 32 bootstrap maps in windows of 16; cv_feat with --quick (2 featurizers x
# 2 l2 values, their width not cut) over 5 folds; production_fit streams
# 512-frame chunks (4 chunks of 2,000 frames, a ragged last one of 464)
EXAMPLE_FRAMES = 2_000
BOOT_MAPS, BOOT_WINDOW = 32, 16
CVFEAT_FOLDS = 5
PROD_CHUNK = 512
# the gauss example's linear residual against the residual of phase 7's
# float64 witness (``sweep_witness``) on the same frames, relative
GAUSS_RESID_LIMIT = 1e-5
EXAMPLE_CHILD_TIMEOUT_S = 300


def example_path(name):
    from pathlib import Path

    return Path(__file__).resolve().parent / "examples" / f"{name}.py"


def load_example(name):
    """An example script by path, as a module (examples/ is no package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"example_{name}", example_path(name))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_example(torch, name, argv, want, failed):
    """``main(argv)`` of an example twin, every count set to 0 just before
    and read just after; the (site_grams, site_grams_tiled) launches must be
    ``want``. Returns (its result, site_grams launches, seconds)."""
    from aggforce_torch.ops.gram import site_grams, site_grams_tiled

    module = load_example(name)
    log(f"examples/{name}.py {' '.join(argv)}:")
    reset_counts()
    t0 = time.perf_counter()
    out = module.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = (site_grams.launches, site_grams_tiled.launches)
    log(f"  {name}: {secs:.3f} s; site_grams launches {got[0]}, site_grams_tiled "
        f"launches {got[1]} (must be {want[0]} and {want[1]})")
    if got != want:
        failed.append(f"{name} launched the Gram kernels {got} times, not {want}")
    return out, got[0], secs


def example_fit_gate(torch, np, label, fits, problem, failed, gate=True, contract=False):
    """Each fit of ``fits`` ({name: (seed, (S, K_exp) coefficients)}) within
    J_GAP_LIMIT of the float64 optimum for the constraint values it meets,
    on the problem of its constraint seed (``fit_problem`` with ``problem``'s
    arguments); a float64 solve of the first seed's problem on a Gram
    without the divergence term, the planted fault, must miss it. With
    ``contract`` the witness solves the problem the solver poses (its
    SOLVER_DELTA ridge on the normalized Gram) and the limit is phase 5's,
    J_GAP_LIMIT + cond * 2**-24 with cond the largest over the sites; the
    distance to the unridged optimum is printed beside it. With ``gate``
    False the gaps are printed only."""
    from aggforce_torch.ops.gram import site_grams_plain

    fault = None
    for name, (seed, coefs) in fits.items():
        gram64, rows64, b64 = fit_problem(
            torch, np, dtype=torch.float64, gram_fn=site_grams_plain, seed=seed, **problem
        )
        gram, rows = gram64.cpu().numpy(), rows64.cpu().numpy()
        n = gram.shape[1]
        p = np.einsum("sii->s", gram) / n
        posed = gram + SOLVER_DELTA * p[:, None, None] * np.eye(n)
        ev = np.linalg.eigvalsh(posed / p[:, None, None])
        cond = float((ev[:, -1] / ev[:, 0]).max())
        limit = J_GAP_LIMIT + cond * F32_EPS if contract else J_GAP_LIMIT
        witness = posed if contract else gram
        log(f"  {label}, {name}: l2 over the mean diagonal of the regularized Gram "
            f"{(problem['l2'] / p).min():.3e} to {(problem['l2'] / p).max():.3e} over "
            f"the sites (the solver's ridge {SOLVER_DELTA:.0e}); condition of the problem "
            f"it poses {cond:.3e}, so cond * 2**-24 = {cond * F32_EPS:.3e}")
        candidates = {name: np.asarray(coefs, np.float64)}
        if fault is None:
            fault = device_solve(fit_problem(
                torch, np, dtype=torch.float32, gram_fn=without_divergence, seed=seed,
                **problem,
            )[0].double(), rows64, b64)
            candidates["planted fault: no divergence term"] = fault
        for key, c in candidates.items():
            gap = objective_gap(np, witness, rows, c)[0]
            note = (f"; to the unridged optimum {objective_gap(np, gram, rows, c)[0]:+.3e}"
                    if contract else "")
            log(f"  {label}, {key}: objective gap to its float64 witness{' (ridged)' if contract else ''} "
                f"{gap:+.3e} (limit {limit:.3e}{'' if gate else ', printed, not gated'}){note}")
            if not gate:
                continue
            if key.startswith("planted fault"):
                if not gap > limit:
                    failed.append(f"{label}: the objective gate does not reject the "
                                  f"planted fault")
            elif not gap <= limit:
                failed.append(f"{label}, {key}: objective gap {gap:.3e} above {limit:.3e}")


def moved(x):
    """A copy of ``x`` with its first entry moved by 1e-3 of its largest."""
    y = x.clone()
    y.view(-1)[0] += 1e-3 * float(x.abs().max())
    return y


def round_trip_gate(label, before, after, planted, failed):
    """A map after save_tmap/load_tmap maps like the map saved: largest
    difference within SERIALIZE_REL_LIMIT of the largest entry; ``planted``
    (the loaded map with one coefficient moved by ``moved``) must not."""
    scale = float(before.abs().max())
    rel = float((after - before).abs().max()) / scale
    rel_fault = float((planted - before).abs().max()) / scale
    log(f"  {label} after save/load: {rel:.3e} of the largest entry off (limit "
        f"{SERIALIZE_REL_LIMIT:.0e}); planted fault {rel_fault:.3e}")
    if not rel <= SERIALIZE_REL_LIMIT:
        failed.append(f"{label}: the save/load round trip")
    if not rel_fault > SERIALIZE_REL_LIMIT:
        failed.append(f"{label}: the round-trip gate does not reject the planted fault")


def examples_gauss(torch, np, failed):
    """examples/torch_gauss.py: no kernel; its linear residual against the
    residual of phase 7's float64 witness on the same frames (a fit without
    constraints, the planted fault, must miss it); the staged map's
    matrices after save/load. Returns its seconds."""
    import aggforce_torch

    out, _, secs = run_example(
        torch, "torch_gauss", ["--device", "cuda", "--frames", str(EXAMPLE_FRAMES)], (0, 0),
        failed,
    )
    log(f"  residuals {out['residuals']}; phase seconds {out['phase_s']}")
    forces = torch.as_tensor(out["forces"], device="cuda")
    cmap, groups = out["coord_map"], out["constraints"]
    witness = sweep_witness(torch, np, forces, cmap, groups)
    expect = float(torch.mean(torch.einsum("sn,tnd->tsd", witness, forces.double()) ** 2))
    fault = aggforce_torch.project_forces(
        out["coords"], out["forces"], cmap, constrained_inds=set(), device="cuda"
    )["residual"]
    for name, value in (("the example's linear residual", out["residuals"]["linear"]),
                        ("planted fault: constrained_inds=set()", float(fault))):
        rel = abs(value - expect) / expect
        log(f"  {name} {value:.6f} against the float64 witness's {expect:.6f}: "
            f"{rel:.3e} relative (limit {GAUSS_RESID_LIMIT:.0e})")
        if name.startswith("planted"):
            if not rel > GAUSS_RESID_LIMIT:
                failed.append("gauss: the residual gate does not reject the planted fault")
        elif not rel <= GAUSS_RESID_LIMIT:
            failed.append("gauss: the linear residual misses the float64 witness")
    staged, loaded = out["staged_map"], out["reloaded_map"]
    for name, a, b in (
        ("gauss premap force map", staged[1].force_map, loaded[1].force_map),
        ("gauss noise-site force map", staged[0].tmap.force_map, loaded[0].tmap.force_map),
    ):
        after = torch.as_tensor(np.asarray(b.standard_matrix))
        round_trip_gate(
            name, torch.as_tensor(np.asarray(a.standard_matrix)), after, moved(after), failed
        )
    return secs


def examples_production(torch, np, tmpdir, failed):
    """examples/torch_production_fit.py in this process (kernel 1 once for
    the warm-up, once for the fit and once per 512-frame chunk; the fit and
    the streamed fit within J_GAP_LIMIT of their float64 optimum; the map
    after save/load) and once more as a fresh process. Returns (the result,
    its kernel-1 launches, seconds, the fresh process's seconds)."""
    import os

    from aggforce_torch.qp.fusedfeat import GBFeatSpec
    from aggforce_torch.utils.serialize import load_tmap

    n_chunks = -(-EXAMPLE_FRAMES // PROD_CHUNK)
    out, launches, secs = run_example(
        torch, "torch_production_fit",
        ["--device", "cuda", "--frames", str(EXAMPLE_FRAMES),
         "--workdir", os.path.join(tmpdir, "production")],
        (2 + n_chunks, 0), failed,
    )
    log(f"  load {out['load_s']:.3f} s beside a warm-up of {out['warmup_s']:.3f} s "
        f"({out['exposed_s']:.3f} s exposed); fit {out['fit_s']:.3f} s; streamed fit "
        f"{out['stream_s']:.3f} s, mapped-force RMS {out['stream_rms']:.3e} off the "
        f"in-memory fit")
    example_fit_gate(
        torch, np, "production",
        {name: (0, np.stack(out[key].force_map.tags["coef_list"]))
         for name, key in (("in-memory fit", "tmap"), ("streamed fit", "streamed"))},
        dict(coords=out["coords"], forces=out["forces"], cmap=out["coord_map"],
             groups=out["constraints"], l2=1e3,
             spec=GBFeatSpec(outer=8.0, inner=0.0, n_basis=7, width=1.0)),
        failed,
    )
    x = torch.as_tensor(out["coords"], device="cuda")
    f = torch.as_tensor(out["forces"], device="cuda")
    loaded = load_tmap(os.path.join(out["workdir"], "force_map.npz"))
    after = loaded.force_map(f, x)
    loaded.force_map._coefs = moved(loaded.force_map._coefs)
    round_trip_gate(
        "production map", out["tmap"].force_map(f, x), after, loaded.force_map(f, x), failed
    )
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(example_path("torch_production_fit")),
         "--frames", str(EXAMPLE_FRAMES), "--workdir", os.path.join(tmpdir, "production2")],
        capture_output=True, text=True, timeout=EXAMPLE_CHILD_TIMEOUT_S,
    )
    child_s = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log(f"  fresh process | {line}")
    log(f"  fresh process: exit {proc.returncode}, {child_s:.1f} s")
    if proc.returncode != 0 or "production fit demo OK" not in proc.stdout:
        failed.append(f"production_fit in a fresh process: exit {proc.returncode}, "
                      f"{proc.stderr[-1500:]}")
    return out, launches, secs, child_s


def examples_bootstrap(torch, np, coords10k, forces10k, tmpdir, failed):
    """examples/torch_bootstrap.py on the synthetic dimer and with --data at
    phase 4's fixture (K_exp = 1,050 at S = 2): kernel 1 once per window;
    every fit finite with its solver residual within 1e-4 (the fit's own
    check of the constraints it meets, after any float64 escalation). The
    first and last seed of each window are printed against their float64
    optimum, not gated: the example's l2 = 1e1 sits below the solver's fixed
    ridge at these widths (l2 over the mean diagonal ~4e-7 at the fixture's
    width, ~2e-6 on the dimer, against 1e-6), so the fits solve a more
    regularized problem, in the JAX package's algorithm as in the port
    (ROADMAP, Queue 3); ``example_kernel_shapes`` gates the Gram at the
    fixture's width instead. Returns {run: (result, kernel-1 launches,
    seconds)}."""
    import os

    from aggforce_torch.qp.fusedfeat import GBFeatSpec

    path = os.path.join(tmpdir, "fixture10k.npz")
    np.savez(path, coords=coords10k, Fs=forces10k)
    argv = ["--device", "cuda", "--n-maps", str(BOOT_MAPS), "--window", str(BOOT_WINDOW)]
    windows = -(-BOOT_MAPS // BOOT_WINDOW)
    seeds = sorted({s for w in range(windows)
                    for s in (w * BOOT_WINDOW, min((w + 1) * BOOT_WINDOW, BOOT_MAPS) - 1)})
    runs = {}
    for run, extra in (("dimer", []), ("fixture width", ["--data", path])):
        out, launches, secs = run_example(
            torch, "torch_bootstrap", argv + extra, (windows, 0), failed
        )
        runs[run] = (out, launches, secs)
        escalated = sum(bool(m.force_map.tags["escalated"]) for m in out["maps"])
        log(f"  {run}: {out['source']}; {escalated} of {BOOT_MAPS} fits escalated to the "
            f"float64 host solve; {out['seconds'] * 1e3 / BOOT_MAPS:.3f} ms per map; "
            f"coefficient spread {out['coef_spread']:.4f}, mean squared mapped force "
            f"{out['msf'].mean():.6f} +/- {out['msf'].std():.6f}, largest solver residual "
            f"{out['resids'].max():.2e}")
        finite = all(bool(torch.isfinite(m.force_map._coefs).all()) for m in out["maps"])
        if not finite or not out["resids"].max() <= 1e-4:
            failed.append(f"bootstrap ({run}): fits not finite ({not finite}) or a solver "
                          f"residual {out['resids'].max():.2e} above 1e-4")
        example_fit_gate(
            torch, np, f"bootstrap ({run})",
            {f"seed {s}": (s, np.stack(out["maps"][s].force_map.tags["coef_list"]))
             for s in seeds},
            dict(coords=out["coords"], forces=out["forces"], cmap=out["coord_map"],
                 groups=set(), l2=1e1,
                 spec=GBFeatSpec(outer=1.0, inner=0.0, n_basis=5, width=1.0)),
            failed, gate=False,
        )
    return runs


def examples_cv_feat(torch, np, tmpdir, failed):
    """examples/torch_cv_feat.py --quick: kernel 1 once per fold of each
    featurizer and once for the refit; the 30 synthesized pairs detected;
    its CV scores equal bit for bit to a direct ``fused_gb_cv_grid`` with the
    same folds (the direct table read with the l2 values swapped, the
    planted fault, must not be); the refit of the best point against the
    float64 optimum of the problem its solver poses, within phase 5's limit
    J_GAP_LIMIT + cond * 2**-24 (the best point can be l2 = 10, where the
    float32 solve resolves the problem to about that). Returns (the result,
    its kernel-1 launches, seconds)."""
    import os

    from aggforce_torch.agg import SCORES_KNAME, SDS_KNAME
    from aggforce_torch.qp.cv import fused_gb_cv_grid
    from aggforce_torch.qp.fusedfeat import recognize_canonical_featurizer

    n_feats = 2
    out, launches, secs = run_example(
        torch, "torch_cv_feat",
        ["--device", "cuda", "--frames", str(EXAMPLE_FRAMES), "--folds", str(CVFEAT_FOLDS),
         "--quick", "--csv", os.path.join(tmpdir, "cv_feat.csv")],
        (n_feats * CVFEAT_FOLDS + 1, 0), failed,
    )
    _, expect_groups, _ = fixture_geometry()
    found = out["constraints"]
    log(f"  {len(found)} pairs detected, equal to the {len(expect_groups)} synthesized: "
        f"{found == set(expect_groups)}; control score {out['control_score']:.4f}, best "
        f"{out['best_score']:.4f}, refit residual {out['refit_residual']:.4f}")
    if found != set(expect_groups):
        failed.append("cv_feat: the detected constraints are not the synthesized pairs")
    feats, l2s = out["featurizers"], out["l2s"]
    specs = [recognize_canonical_featurizer(f) for f in feats]
    t0 = time.perf_counter()
    direct = fused_gb_cv_grid(
        out["coords"], out["forces"], out["coord_map"], found, out["kbt"], specs, l2s,
        n_folds=CVFEAT_FOLDS, n_constraint_frames=20, rng=np.random.default_rng(0),
        device="cuda",
    )
    direct_s = time.perf_counter() - t0
    swapped = dict(zip(l2s, reversed(l2s)))
    equal, fault_equal = True, True
    for label, score in out["results"][SCORES_KNAME].items():
        fi, l2 = feats.index(label.featurizer), float(label.l2_regularization)
        mean, sd, _ = direct[(fi, l2)]
        planted = direct[(fi, float(swapped[l2]))][0]
        equal &= score == mean and out["results"][SDS_KNAME][label] == sd
        fault_equal &= score == planted
        log(f"  n_basis {specs[fi].n_basis}, l2 {l2:g}: score {score:.6f}, direct "
            f"fused_gb_cv_grid {mean:.6f}, planted fault (l2 swapped) {planted:.6f}")
    log(f"  the example's scores equal the direct call's ({direct_s:.3f} s) bit for bit: "
        f"{equal}; the planted fault's: {fault_equal}")
    if not equal:
        failed.append("cv_feat: the example's CV scores differ from fused_gb_cv_grid's")
    if fault_equal:
        failed.append("cv_feat: the score gate does not reject the planted fault")
    best = out["best"]
    tags = out["refit"]["tmap"].force_map.tags
    log(f"  refit of the best point: solver residual {tags['solver_resid']:.2e}, escalated "
        f"{tags['escalated']}")
    example_fit_gate(
        torch, np, "cv_feat refit",
        {"refit of the best point": (0, np.stack(tags["coef_list"]))},
        dict(coords=out["coords"], forces=out["forces"], cmap=out["coord_map"],
             groups=found, l2=float(best.l2_regularization),
             spec=recognize_canonical_featurizer(best.featurizer)),
        failed, contract=True,
    )
    return out, launches, secs


def example_kernel_shapes(torch, np, prod, boot, cv):
    """Kernel 1 against its plain version (phase 1's atol) at the shapes the
    examples gave it, at the bootstrap's fixture width also against a
    float64 sum (phase 3's gate, with its planted fault), and its times at
    them (``gram_kernel_times`` without the stage probe). Returns ({shape:
    report}, max abs error)."""
    from aggforce_torch.qp.cv import _fold_segments
    from aggforce_torch.qp.fusedfeat import GBFeatSpec, recognize_canonical_featurizer

    boot_spec = GBFeatSpec(outer=1.0, inner=0.0, n_basis=5, width=1.0)
    prod_spec = GBFeatSpec(outer=8.0, inner=0.0, n_basis=7, width=1.0)
    fold = _fold_segments(EXAMPLE_FRAMES, CVFEAT_FOLDS, np.random.default_rng(0))[0]
    tail = EXAMPLE_FRAMES - (EXAMPLE_FRAMES // PROD_CHUNK) * PROD_CHUNK
    shapes = []
    for run, (out, _, _) in boot.items():
        t = len(out["coords"])
        shapes.append((f"bootstrap, {run} (T={t}, S=2)", out["coords"], out["forces"],
                       out["coord_map"], set(), boot_spec, True))
    shapes += [
        (f"production_fit, streamed chunk (T={PROD_CHUNK})", prod["coords"][:PROD_CHUNK],
         prod["forces"][:PROD_CHUNK], prod["coord_map"], prod["constraints"], prod_spec, True),
        (f"production_fit, last streamed chunk (T={tail})", prod["coords"][-tail:],
         prod["forces"][-tail:], prod["coord_map"], prod["constraints"], prod_spec, False),
    ]
    for feat in cv["featurizers"]:
        spec = recognize_canonical_featurizer(feat)
        shapes.append((f"cv_feat fold, n_basis {spec.n_basis} (T={len(fold)})",
                       cv["coords"][fold], cv["forces"][fold], cv["coord_map"],
                       cv["constraints"], spec, True))
    reports, errs = {}, []
    for label, coords, forces, cmap, groups, spec, timed in shapes:
        ops = packed_operands(torch, coords, forces, cmap, groups, spec)
        g_pad, s = ops[0].shape[2], ops[1].shape[0]
        g = real_groups(ops[5][:g_pad])
        label = f"{label}, G={g}, K_exp={g * (1 + spec.n_basis)}"
        errs.append(compare_kernel(torch, ops, spec.n_basis, label))
        if label.startswith("bootstrap, fixture width"):
            gram_error_vs_float64(ops, spec.n_basis)
        if timed:
            reports[label] = gram_kernel_times(
                torch, ops, spec.n_basis, f"site_grams at {label}", stages=False
            )
        del ops
    return reports, max(errs)


def phase_examples(torch, np, coords10k, forces10k, smi, tmpdir):
    """Phase 15: the four example twins on the card, each loaded by path and
    driven through its ``main`` (production_fit also as a fresh process),
    at the JAX examples' sizes (cv_feat's grid cut to --quick, its width
    not); their gates; kernel 1 at their shapes. Returns ({path: kernel-1
    launches}, {shape: kernel-1 report}, max abs error, seconds)."""
    t_phase = time.perf_counter()
    failed = []
    gauss_s = examples_gauss(torch, np, failed)
    prod, prod_launches, prod_s, child_s = examples_production(torch, np, tmpdir, failed)
    boot = examples_bootstrap(torch, np, coords10k, forces10k, tmpdir, failed)
    cv, cv_launches, cv_s = examples_cv_feat(torch, np, tmpdir, failed)
    if failed:
        fail("phase 15: " + "; ".join(failed))
    reports, max_err = example_kernel_shapes(torch, np, prod, boot, cv)
    launches = {
        "example torch_gauss.py": 0,
        "example torch_production_fit.py (warm-up, fit, one per 512-frame chunk)":
            prod_launches,
        **{f"example torch_bootstrap.py, {run} (one per window)": n
           for run, (_, n, _) in boot.items()},
        "example torch_cv_feat.py (one per fold of each featurizer, one refit)":
            cv_launches,
    }
    phase_s = time.perf_counter() - t_phase
    log(f"phase 15 (example twins) {phase_s:.1f} s: gauss {gauss_s:.1f} s, production_fit "
        f"{prod_s:.1f} s (a fresh process {child_s:.1f} s), bootstrap "
        f"{', '.join(f'{run} {s:.1f} s' for run, (_, _, s) in boot.items())}, cv_feat "
        f"{cv_s:.1f} s ({smi})")
    return launches, reports, max_err, phase_s


def main() -> int:
    if sys.argv[1:2] == ["--warmup-child"]:
        return warmup_child(*sys.argv[2:4])
    if sys.argv[1:2] == ["--mesh-child"]:
        return mesh_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    import tempfile

    import numpy as np
    import torch

    smi = phase_environment(torch)
    phase_build()
    from aggforce_torch.qp.fusedfeat import GBFeatSpec

    coords, forces, cmap, groups = fixture()
    spec = GBFeatSpec(outer=OUTER, n_basis=N_BASIS, width=WIDTH)
    ops, fold_ops, max_err = phase_kernels(torch, np, coords, forces, cmap, groups, spec)
    detection = phase_detection(torch, np, coords, groups, smi)
    spec, launches, first_fit_s, peak_bytes, problem64 = phase_main_path(
        torch, np, coords, forces, cmap, groups, smi
    )
    log(f"first fit {first_fit_s:.3f} s; peak device memory of the main path "
        f"{peak_bytes / 2**20:.1f} MiB ({smi})")
    times, single_med = phase_times(torch, np, coords, forces, cmap, groups, spec, ops)
    fold_times = gram_kernel_times(
        torch, fold_ops, spec.n_basis, "site_grams at the config-#4 fold shape"
    )
    del ops, fold_ops
    cv_launches, cv_first_s, cv_min, cv_med, cv_table = phase_cv_config4(
        torch, np, coords, forces, cmap, groups, spec, smi
    )
    grid_launches = phase_cv_grids(torch, np, coords, forces, cmap, groups)
    batch_launches, s_per_fit = phase_batch(
        torch, np, coords, forces, cmap, groups, spec, single_med, smi
    )
    log(f"config #4 CV: first {cv_first_s:.3f} s, min {cv_min:.4f} s, median "
        f"{cv_med:.4f} s ({N_FRAMES / cv_med:.1f} frames/s); batch fits "
        f"{s_per_fit * 1e3:.3f} ms per fit against {single_med * 1e3:.2f} ms single "
        f"({smi})")
    tiled_launches, tiled_err, tiled_times, sweep = phase_sweep(torch, np, smi)
    phase_linear_config1(torch, np, coords, forces, cmap, groups, spec, smi)
    phase_gauss_config2(torch, np, coords, forces, cmap, groups, smi)
    phase_linear_sweep(torch, np, smi)
    generic_s = phase_generic(torch, np, coords, forces, cmap, groups, spec, smi)
    with tempfile.TemporaryDirectory(prefix="aggforce_smoke_") as tmpdir:
        streamed = phase_streamed_featurized(torch, np, cmap, groups, spec, smi, tmpdir)
        stream_launches, stream_times, stream_err, stream_s, stream_gram_s, stream64 = streamed
        linear_stream_s = phase_streamed_linear(torch, np, smi, tmpdir)
        warm = phase_staging_persistence_warmup(
            torch, np, coords, forces, cmap, groups, spec, smi, tmpdir
        )
        mesh_one, mesh_two, shard_times = phase_mesh(
            torch, np, coords, forces, cmap, groups, spec, problem64, cv_table, sweep,
            stream64, tmpdir, smi,
        )
        example_launches, example_times, example_err, _ = phase_examples(
            torch, np, coords, forces, smi, tmpdir
        )
    del sweep
    log(f"generic path {generic_s['device']:.3f} s (device backend), "
        f"{generic_s['host']:.3f} s (host backend) at {GENERIC_FRAMES} frames; "
        f"streamed featurized fit {stream_s:.3f} s (its Gram {stream_gram_s:.3f} s) at "
        f"{STREAM_FRAMES} frames; "
        f"streamed linear fit {linear_stream_s:.3f} s at {LINEAR_STREAM_FRAMES} frames; "
        f"first fit in a fresh process {warm['without']['first_fit_s']:.3f} s without "
        f"warm-up, {warm['with']['first_fit_s']:.3f} s with ({smi})")
    def mesh_paths(kernel):
        """Launches of ``kernel`` on the mesh paths: one NCCL rank's, and
        each of the two gloo ranks' (one count per rank)."""
        paths = {
            f"mesh, one rank (NCCL): {label}": got[kernel]
            for label, got in mesh_one.items() if got[kernel]
        }
        for label in mesh_two[0]:
            per_rank = [rank[label][kernel] for rank in mesh_two]
            if any(per_rank):
                paths[f"mesh, two ranks on one card (gloo), per rank: {label}"] = per_rank
        return paths

    def mesh_total(kernel):
        return sum(sum(v) if isinstance(v, list) else v for v in mesh_paths(kernel).values())

    kernels = [
        {
            "name": "site_grams",
            "route": "cuda",
            "source": "aggforce_torch/csrc/site_grams.cu",
            "replaces": "aggforce_tpu/ops/pallas_gram.py:36",
            "launches": (
                launches + cv_launches + grid_launches + batch_launches + stream_launches
                + mesh_total("site_grams") + sum(example_launches.values())
            ),
            "launches_by_path": {
                "config #3 fit (project_forces)": launches,
                "config #4 CV (fused_gb_cv)": cv_launches,
                "featurized grid (project_forces_grid_cv)": grid_launches,
                "batch fits (fused_gb_linear_map_batch)": batch_launches,
                "config #2 (Gaussian maps)": 0,
                "streamed featurized fit (fused_gb_linear_map_streamed)": stream_launches,
                "generic featurizer path (qp_feat_linear_map, allow_fused=False)": 0,
                "streamed linear fit (qp_linear_map_streamed)": 0,
                **mesh_paths("site_grams"),
                **example_launches,
            },
            "max_abs_err": max(max_err, stream_err, shard_times["max_abs_err"], example_err),
            **times,
            "at_fold_shape": fold_times,
            "at_stream_chunk_shape": stream_times,
            "at_mesh_shard_shape": shard_times,
            "at_example_shapes": example_times,
        },
        {
            "name": "site_grams_tiled",
            "route": "cuda",
            "source": "aggforce_torch/csrc/site_grams_tiled.cu",
            "replaces": "aggforce_tpu/ops/pallas_gram.py:313",
            "launches": tiled_launches + mesh_total("site_grams_tiled"),
            "launches_by_path": {
                "sweep fit (fused_gb_linear_map_blocked)": tiled_launches,
                "config #2 (Gaussian maps)": 0,
                "streamed featurized fit (fused_gb_linear_map_streamed)": 0,
                "generic featurizer path (qp_feat_linear_map, allow_fused=False)": 0,
                "streamed linear fit (qp_linear_map_streamed)": 0,
                **mesh_paths("site_grams_tiled"),
                **{path: 0 for path in example_launches},
            },
            "max_abs_err": tiled_err,
            **tiled_times,
        },
        {
            "name": "pair_moments",
            "route": "cuda",
            "source": "aggforce_torch/csrc/pair_moments.cu",
            "replaces": "none (the JAX package's finder is XLA: "
                        "aggforce_tpu/constraints/finder.py:38)",
            "launches": sum(DETECT_LAUNCHES.values()),
            "launches_by_path": dict(DETECT_LAUNCHES),
            **detection,
        },
        {
            "name": "gb_apply",
            "route": "cuda",
            "source": "aggforce_torch/csrc/gb_apply.cu",
            "replaces": "none (the JAX package's fused apply is XLA: "
                        "aggforce_tpu/qp/fusedfeat.py:468)",
            "launches": sum(APPLY_LAUNCHES.values()),
            "launches_by_path": dict(APPLY_LAUNCHES),
            **next(iter(APPLY_REPORTS.values())),
            "at_shapes": dict(list(APPLY_REPORTS.items())[1:]),
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
