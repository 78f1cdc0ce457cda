"""Kernel 1's share of its roofline (``csrc/site_grams.cu``).

Numerator: the least time the chip could take for the traced fits' Grams,
the larger of their operations at the TF32 peak and their bytes at the HBM
peak. Each unique entry of each site's Gram over the G real groups is
counted once: 3T rows, S sites, K_exp = G (1 + n_basis) columns, 2 flops a
term, so 3T S K_exp (K_exp + 1) flops. Bytes: the frames' coordinates and
forces read once (2 x 3 T N float32) and the unique Gram entries written
once (S K_exp (K_exp + 1) / 2 float32). Denominator: the device time of the
kernels this file names, over the traced window."""

from benchmark.peaks import least_seconds

KERNELS = ("site_grams_build", r"site_grams_product<.*FlatStore")


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
