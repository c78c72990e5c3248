"""Operations and bytes of the work, counted from shapes: the same count
whatever implements it. Peaks are the published dense rates of one NVIDIA
H100 SXM (bf16 989 TFLOP/s, HBM 3.35 TB/s)."""

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
