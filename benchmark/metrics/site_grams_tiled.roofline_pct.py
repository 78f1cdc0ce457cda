"""Kernel 2's share of its roofline (``csrc/site_grams_tiled.cu``), counted
as kernel 1's: 3T S K_exp (K_exp + 1) flops over all S sites of a fit (the
blocked fit's padding sites are not work), the frames read once and the
unique Gram entries written once, against the TF32 and HBM peaks; the
denominator is the device time of the kernels whose names match ``KERNELS``."""

from benchmark.peaks import least_seconds

KERNELS = ("site_grams_build", r"site_grams_product<.*PairStore")


def flops(shapes, t):
    k = shapes["K_exp"]
    return 3.0 * t * shapes["S"] * k * (k + 1)


def nbytes(shapes, t):
    k = shapes["K_exp"]
    return 4.0 * (2 * 3 * t * shapes["N"] + shapes["S"] * k * (k + 1) / 2)


def read(run):
    if run.trace is None or not run.fit_seconds:
        return None
    spent = run.trace.kernel_seconds(KERNELS)
    if not spent:
        return None
    t = run.frames_per_fit
    least = len(run.fit_seconds) * least_seconds(flops(run.shapes, t), nbytes(run.shapes, t))
    return 100.0 * least / spent
