"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense rates at
the 700 W power limit (NVIDIA's data sheet); the attention peaks are
chip_smoke.py's ``ACCURATE_PEAK_OPS_PER_S`` at commit aeb5374."""

HBM_BYTES_PER_S = 3.35e12

# matrix products as the model runs them: float32 with TF32 off runs on
# the CUDA cores; bfloat16 on the tensor cores
MATMUL_FLOPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}

# the attention kernel's own bound: the fastest way the card keeps each
# type's accuracy, so no implementation can beat it: float32 as three
# TF32 products a product on the tensor cores (495 / 3 TFLOP/s), which
# is above the CUDA cores' 67; bfloat16 on the tensor cores
ATTENTION_FLOPS_PER_S = {"float32": 495e12 / 3, "bfloat16": 989e12}
