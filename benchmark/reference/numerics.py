"""Precision modes and the equality-constrained least-squares solve shared by
the references."""

from contextlib import contextmanager

import torch

PRECISIONS = ("float64", "tf32")


def dtype_of(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, not {precision!r}")
    return torch.float64 if precision == "float64" else torch.float32


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to nearest on TF32's 10-bit mantissa."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b``: exact float64 products, or TF32-rounded operands summed in
    float32."""
    if precision == "tf32":
        return torch.matmul(round_tf32(a), round_tf32(b))
    return torch.matmul(a, b)


@contextmanager
def full_precision():
    """Products inside run on their operands as given (no TF32 rounding by
    the library); the switches are restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def eq_lstsq(
    p: torch.Tensor, a: torch.Tensor, b: torch.Tensor, precision: str
) -> torch.Tensor:
    """argmin x^T P x subject to A x = B, column by column.

    P (n, n) positive definite, A (m, n), B (m, k). Rows of A are scaled to
    unit norm first. With L the Cholesky factor of P and W = L^-1 A^T, the
    multipliers solve (W^T W) lam = B through the pseudo-inverse (cut at m
    float epsilons of the largest eigenvalue), so exactly repeated
    constraint rows with equal targets are taken once; x = L^-T W lam.
    """
    norms = torch.linalg.vector_norm(a, dim=1, keepdim=True).clamp_min(1e-300)
    a, b = a / norms, b / norms
    chol = torch.linalg.cholesky(p)
    w = torch.linalg.solve_triangular(chol, a.T, upper=False)
    evals, evecs = torch.linalg.eigh(mm(w.T, w, precision))
    keep = evals > evals[-1] * a.shape[0] * torch.finfo(p.dtype).eps
    inv = torch.where(keep, 1.0 / torch.where(keep, evals, torch.ones_like(evals)), 0.0)
    lam = mm(evecs * inv, mm(evecs.T, b, precision), precision)
    return torch.linalg.solve_triangular(chol.T, mm(w, lam, precision), upper=True)


def max_violation(a: torch.Tensor, x: torch.Tensor, b: torch.Tensor) -> float:
    """max |A x - B| over rows scaled to unit norm (float64)."""
    a, x, b = a.double(), x.double(), b.double()
    norms = torch.linalg.vector_norm(a, dim=1, keepdim=True).clamp_min(1e-300)
    return float(torch.max(torch.abs((a @ x - b) / norms)))
