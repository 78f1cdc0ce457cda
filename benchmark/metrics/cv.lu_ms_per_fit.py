"""Device milliseconds a traced study of the batched LU that solves the
featurized CV's (l2, fold, site) KKT systems in float64
(``ops.eqp.batched_eqp_solve_kkt``: ``torch.linalg.lu_factor`` and
``lu_solve`` on the card, which torch hands to MAGMA's batched kernels):
the device time of MAGMA's double-precision batched LU kernels (the
factor's GEMM updates, pivot search, row swaps and column steps, and the
triangular solves), inside the window, over the traced studies. None where
none ran (a program that solves the CV otherwise, such as one whose
batched solves are float32 Cholesky factorizations)."""

KERNELS = (
    r"gemm_template_batched\w*<double",
    r"batch_trsm\w*<double",
    r"\bidamax\w*_batched",
    r"\bdlaswp\w*_batched",
    r"\bdswap\w*_batched",
    r"computecolumn\w*_batched",
)


def read(run):
    if run.trace is None or not run.fit_seconds:
        return None
    spent = run.trace.kernel_seconds(KERNELS)
    if not spent:
        return None
    return 1e3 * spent / len(run.fit_seconds)
