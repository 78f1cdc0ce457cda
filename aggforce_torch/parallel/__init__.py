"""Multi-process scaling: frame-sharded Gram reductions and distributed fits."""
# ruff: noqa: F401
from .mesh import (
    FrameMesh,
    batched_eqp_solve_shared_mesh,
    make_mesh,
    sharded_force_smoothness,
    sharded_linear_fit,
)
from .distributed import (
    global_frame_mesh,
    initialize_distributed,
    process_frame_slice,
)
