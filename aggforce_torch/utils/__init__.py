"""Generic helpers: partial application, flattening, device choice, synthetic data."""
# ruff: noqa: F401
from .funcs import curry, Curry, flatten
from .device import resolve_device
