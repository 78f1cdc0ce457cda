"""Where the port's work runs.

Every entry point takes ``device=None``. A tensor argument keeps the device
it already lies on; otherwise ``None`` means the CUDA card. The CPU is used
only when the caller asks for it (``device="cpu"``) or hands in CPU tensors:
a missing card is an error, never a silent fall back to the host.
"""

from contextlib import contextmanager
from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


@contextmanager
def full_fp32():
    """float32 cuBLAS products at full precision (no TF32) inside the block.

    The port's products, like the JAX package's ``precision="highest"``,
    must not round their operands to TF32, whatever the process has set;
    the setting is restored on exit. torch has two linked switches, and
    refuses a mix of them: the one in use is the one flipped. The newer
    ``torch.backends.cuda.matmul.fp32_precision`` is read first, so the
    common case (full precision already) costs one attribute read; the
    legacy ``float32_matmul_precision`` reads fine unless the newer switch
    has been set, and then it raises.
    """
    matmul = torch.backends.cuda.matmul
    if getattr(matmul, "fp32_precision", None) == "ieee":
        yield
        return
    try:
        legacy = torch.get_float32_matmul_precision()
    except RuntimeError:
        legacy = None
    if legacy == "highest":
        yield
        return
    if legacy is not None:
        torch.set_float32_matmul_precision("highest")
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(legacy)
        return
    prev = matmul.fp32_precision
    matmul.fp32_precision = "ieee"
    try:
        yield
    finally:
        matmul.fp32_precision = prev


def resolve_device(device: DeviceLike = None, *arrays) -> torch.device:
    """The device to run on, from an explicit choice or the inputs.

    ``arrays`` are the call's array arguments: the first torch tensor among
    them fixes the device when ``device`` is None. Raises RuntimeError when
    the result is a CUDA device and CUDA is not available.
    """
    if device is None:
        tensor = next((a for a in arrays if isinstance(a, torch.Tensor)), None)
        device = tensor.device if tensor is not None else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: aggforce_torch runs on the GPU by default; "
            "pass device='cpu' to run on the CPU."
        )
    return dev

