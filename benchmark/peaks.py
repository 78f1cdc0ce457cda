"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit). The benchmark states roofline shares
against these, with the card's power limit printed beside them."""

# TF32 tensor-core rate: the fastest rate at which the chip multiplies
# 32-bit operands, so the least time any float32 Gram could take
TF32_FLOPS = 495e12
# HBM3 bandwidth
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The larger of the operations' time at the TF32 peak and the bytes'
    time at the HBM peak."""
    return max(flops / TF32_FLOPS, nbytes / HBM_BYTES_PER_S)
