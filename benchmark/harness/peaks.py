"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # float32 on the CUDA cores
TF32_FLOPS = 495e12  # TF32 on the tensor cores
# the most float32-accurate matrix work the card gives: 3xTF32, three TF32
# products a multiply-add
FP32_ACCURATE_MATMUL_FLOPS = TF32_FLOPS / 3.0
