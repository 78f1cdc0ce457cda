"""The float64 fold-Gram kernel's share of its roofline
(``aggforce_site_grams_f64`` of ``csrc/site_grams.cu``: kernel 1's row
build and its fp64 product stage), over a traced study's featurizer grid.

Numerator: the least time the chip could take for the study's fold Grams,
the larger of their operations at the H100's fp64 peak (its tensor cores,
the fastest fp64 rate it has) and their bytes at the HBM peak. The
operations are the check's ``work``: each unique entry of each site's Gram
over the G real groups, every featurizer's folds covering the window once,
3T S K_exp (K_exp + 1) flops a featurizer. Bytes: each featurizer reads the
frames' coordinates and forces once (2 x 3 T N float32) and writes each
fold's unique Gram entries once (S K_exp (K_exp + 1) / 2 float64).
Denominator: the device time of the row build and the fp64 product over
the traced window. None where the fp64 product did not run (a program
without it, whose 3xTF32 entry launches the same row build)."""

from benchmark.peaks import HBM_BYTES_PER_S

# fp64 tensor-core rate of one H100 SXM (NVIDIA's data sheet, dense)
FP64_FLOPS = 67e12
BUILD = ("site_grams_build",)
PRODUCT = ("site_grams_product_f64",)


def nbytes(run, t):
    sh = run.shapes
    ks = run.cell.check.grid_ks(sh)
    entries = sum(k * (k + 1) / 2 for k in ks)
    return len(ks) * 4.0 * 2 * 3 * t * sh["N"] + 8.0 * int(run.cell.config["n_folds"]) * sh["S"] * entries


def read(run):
    if run.trace is None or not run.fit_seconds:
        return None
    product = run.trace.kernel_seconds(PRODUCT)
    if not product:
        return None
    spent = product + (run.trace.kernel_seconds(BUILD) or 0.0)
    t = run.frames_per_fit
    least = max(run.cell.check.work(run.shapes, t) / FP64_FLOPS, nbytes(run, t) / HBM_BYTES_PER_S)
    return 100.0 * len(run.fit_seconds) * least / spent
