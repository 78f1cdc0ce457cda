"""Generic helpers: partial application, flattening, device choice, synthetic
data, the kernels' build directory and the warm-up."""
# ruff: noqa: F401
from .funcs import curry, Curry, flatten
from .device import resolve_device
from .cache import enable_compile_cache
from .warmup import (
    WarmupHandle,
    warm_featurized_batch,
    warm_featurized_fit,
    warm_gauss_fit,
    warm_linear_fit,
)
