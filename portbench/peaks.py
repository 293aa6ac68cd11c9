"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the 700 W power limit): float32 outside the tensor cores, bfloat16 on
the tensor cores, HBM3 bandwidth."""

PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
