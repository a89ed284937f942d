"""Peak rates of one NVIDIA H100 SXM at 700 W (NVIDIA's data sheet, dense):
the denominators of every bound that chip_smoke.py and the tools report."""
H100_BYTES_PER_S = 3.35e12  # HBM3
H100_FP32_FLOPS = 67e12     # float32 on the CUDA cores
H100_TF32_FLOPS = 495e12    # TF32 on the tensor cores
H100_BF16_FLOPS = 989e12    # bf16 on the tensor cores
