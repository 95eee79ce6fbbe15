"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, 700 W): HBM3 bandwidth and the float32 rate outside the tensor
cores (TF32 is off in the program)."""

BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def bound_s(n_bytes: float, flop: float) -> float:
    """The least time the card could take: the larger of the bytes at
    the bandwidth and the operations at the float32 rate."""
    return max(n_bytes / BYTES_PER_S, flop / FP32_FLOP_PER_S)
