"""Where the port's work runs.

Every entry point takes ``device=None``. A tensor argument keeps the device
it already lies on; otherwise ``None`` means the CUDA card. The CPU is used
only when the caller asks for it (``device="cpu"``) or hands in CPU tensors:
a missing card is an error, never a silent fall back to the host.
"""

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


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

