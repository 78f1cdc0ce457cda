"""The linear fit's Gram's share of its roofline
(``qp.qplinear._linear_gram``: per frame block a transposing copy, the
group sums by ``index_add_`` and one SGEMM).

Numerator: the least time for the traced fits' Grams (F C)^T (F C), each
unique entry over the 3T design rows counted once, 3T R (R + 1) flops, and
the forces read once (3 T N float32) with the unique entries written once
(R (R + 1) / 2 float32), at the TF32 and HBM peaks. Denominator: the device
time of the kernels whose names match ``KERNELS``, over the traced window."""

from benchmark.peaks import least_seconds

# the Gram's SGEMM (``addmm_`` of the transposed design block, CUTLASS's
# SIMT kernel: R is no multiple of 4, so align1) and its group sums
# (``index_add_``); the transposing copy is left out, as its kernel's name
# is every other copy's too
KERNELS = (r"simt_sgemm_.*_nt_align1", "indexFuncLargeIndex")


def flops(shapes, t):
    r = shapes["R"]
    return 3.0 * t * r * (r + 1)


def nbytes(shapes, t):
    r = shapes["R"]
    return 4.0 * (3 * t * shapes["N"] + r * (r + 1) / 2)


def read(run):
    if run.trace is None or not run.fit_seconds:
        return None
    spent = run.trace.kernel_seconds(KERNELS)
    if not spent:
        return None
    t = run.frames_per_fit
    least = len(run.fit_seconds) * least_seconds(flops(run.shapes, t), nbytes(run.shapes, t))
    return 100.0 * least / spent
