"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its full 700 W power limit). A card set below 700 W reaches
less, so every share of a peak is printed with the card's name and power
limit beside it (`run.py`)."""

F32_FLOPS = 67.0e12  # float32 outside the tensor cores (B1/B2's arithmetic)
F64_FLOPS = 67.0e12  # float64 on the tensor cores (cuBLAS/cuSOLVER DGEMM)
HBM_BYTES = 3.35e12  # HBM3 bandwidth, bytes a second
