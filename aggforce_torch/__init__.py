"""aggforce_torch: optimal force aggregation in PyTorch, on NVIDIA GPUs.

The PyTorch/CUDA port of the JAX package in the same repository. Given an
atomistic trajectory (coordinates + forces) and a configurational
coarse-graining map, it derives optimal force maps such that mapped forces
estimate the CG mean force.

The public API mirrors the JAX package. Work runs on the CUDA card by
default (``device=None`` means ``"cuda"``); pass ``device="cpu"`` to run on
the host. The per-site featurized Gram, the hot op of the featurized fit,
is a hand-written CUDA kernel (``csrc/site_grams.cu``) built on first use;
the sweep-scale site-blocked fit (``qp.fused_gb_linear_map_blocked``) runs
a second one (``csrc/site_grams_tiled.cu``).

Primary entry point: :func:`project_forces`.
"""

# ruff: noqa: F401
from .trajectory import Trajectory
from .agg import project_forces, force_smoothness
from .map import LinearMap, TLinearMap
from .qp import qp_feat_linear_map, id_feat, gb_feat, Multifeaturize
from .utils.funcs import Curry

__version__ = "0.1.0"
