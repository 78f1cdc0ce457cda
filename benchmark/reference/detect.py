"""Plain reference of constraint detection: atom pairs whose distance varies
over the frames by a standard deviation below ``threshold`` (1e-3, the
library's default) are constrained."""

from typing import Set, Tuple

import torch

from .numerics import dtype_of, mm

THRESHOLD = 1e-3
# frames per block: 64 x 175 x 175 distances
FRAME_BLOCK = 64


def _distances(x: torch.Tensor, precision: str) -> torch.Tensor:
    """(t, N, N) distances; in float64 from coordinate differences, in the
    control from the Gram |a|^2 + |b|^2 - 2 a.b with TF32 products."""
    if precision == "float64":
        diff = x[:, :, None, :] - x[:, None, :, :]
        return torch.sqrt(torch.sum(diff * diff, dim=-1))
    sq = torch.sum(x * x, dim=-1)
    cross = mm(x, x.transpose(1, 2), precision)
    return torch.sqrt(torch.clamp(sq[:, :, None] + sq[:, None, :] - 2.0 * cross, min=0.0))


def detect(coords: torch.Tensor, precision: str = "float64", threshold: float = THRESHOLD) -> Set[Tuple[int, int]]:
    """Constrained pairs (i < j) of (T, N, 3) coordinates."""
    dt = dtype_of(precision)
    x0 = coords[:1].to(dt)
    d0 = _distances(x0, precision)[0]
    s1 = torch.zeros_like(d0)
    s2 = torch.zeros_like(d0)
    t = coords.shape[0]
    for lo in range(0, t, FRAME_BLOCK):
        delta = _distances(coords[lo : lo + FRAME_BLOCK].to(dt), precision) - d0
        s1 += delta.sum(dim=0)
        s2 += (delta * delta).sum(dim=0)
    mean = s1 / t
    sd = torch.sqrt(torch.clamp(s2 / t - mean * mean, min=0.0))
    hits = torch.triu(sd < threshold, diagonal=1).nonzero().tolist()
    return {(int(i), int(j)) for i, j in hits}

