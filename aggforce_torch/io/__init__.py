"""Trajectory IO: streaming fits and timed device staging."""

from .staging import StagingReport, stage_arrays, stage_trajectory
from .stream import (
    TrajectoryStream,
    fused_gb_linear_map_streamed,
    qp_linear_map_streamed,
)

__all__ = [
    "StagingReport",
    "TrajectoryStream",
    "fused_gb_linear_map_streamed",
    "qp_linear_map_streamed",
    "stage_arrays",
    "stage_trajectory",
]
