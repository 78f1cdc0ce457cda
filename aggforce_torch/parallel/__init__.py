"""Multi-process scaling: frame-sharded Gram reductions and distributed fits."""
# ruff: noqa: F401
from .mesh import (
    FrameMesh,
    make_mesh,
    sharded_force_smoothness,
)
from .distributed import (
    global_frame_mesh,
    initialize_distributed,
    process_frame_slice,
)


def __getattr__(name):
    # the mesh's linear fit is the device linear fit of qp.qplinear, which
    # imports this package: re-exported on first use, not at import
    if name == "sharded_linear_fit":
        from ..qp.qplinear import sharded_linear_fit

        return sharded_linear_fit
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
