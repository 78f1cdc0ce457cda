"""Kernel 2's share of its roofline (``csrc/site_grams_tiled.cu``), counted
as kernel 1's: 3T S K_exp (K_exp + 1) flops over all S sites of a fit (the
blocked fit's padding sites are not work), the frames read once and the
unique Gram entries written once, against the TF32 and HBM peaks; the
denominator is the device time of the kernels whose names match ``KERNELS``.

On a cell of n chips the ranks split the sites and each reads every frame:
the flops and the Gram entries are divided by n (an average rank's share)
and set against rank 0's kernel time. Where rank 0 fits more sites than the
average (18 of 66 on four ranks with blocks of 6), this reads at or below
its own share; with one chip it is the whole fit's."""

from benchmark.peaks import least_seconds

KERNELS = ("site_grams_build", r"site_grams_product<.*PairStore")


def flops(shapes, t, chips=1):
    k = shapes["K_exp"]
    return 3.0 * t * shapes["S"] * k * (k + 1) / chips


def nbytes(shapes, t, chips=1):
    k = shapes["K_exp"]
    return 4.0 * (2 * 3 * t * shapes["N"] + shapes["S"] * k * (k + 1) / 2 / chips)


def read(run):
    if run.trace is None or not run.fit_seconds:
        return None
    spent = run.trace.kernel_seconds(KERNELS)
    if not spent:
        return None
    t, n = run.frames_per_fit, run.cell.chips
    least = len(run.fit_seconds) * least_seconds(flops(run.shapes, t, n), nbytes(run.shapes, t, n))
    return 100.0 * least / spent
