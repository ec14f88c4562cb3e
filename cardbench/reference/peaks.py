"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W power limit), and the least time a piece of work
needs at them (the arithmetic of ``chip_smoke.py:bound``)."""

PEAK_HBM_BYTES = 3.35e12          # bytes/s
PEAK_FP32_FLOPS = 67e12           # outside the tensor cores
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12


def least_seconds(n_bytes: float, flops: float,
                  peak_flops: float = PEAK_FP32_FLOPS) -> float:
    """The larger of ``n_bytes`` at the HBM bandwidth and ``flops`` at
    ``peak_flops``."""
    return max(n_bytes / PEAK_HBM_BYTES, flops / peak_flops)
