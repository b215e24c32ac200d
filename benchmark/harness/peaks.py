"""The card's published peaks (NVIDIA H100 SXM data sheet, dense, at the
full 700 W power limit), against which shares of a peak are stated."""

PEAK_BF16_FLOPS = 989e12  # tensor-core bf16 / fp16
PEAK_HBM_BYTES = 3.35e12  # HBM3 bytes a second
