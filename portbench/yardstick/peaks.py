"""Peaks of one NVIDIA H100 SXM (80 GB HBM3), from NVIDIA's data sheet:
dense rates at the full 700 W power limit.  A frozen copy of the port's
``launch/hw.py`` figures, so that a later change to the program cannot
move the yardstick."""

PEAK_FLOPS_BF16 = 989e12       # FLOP/s, dense bf16 on the tensor cores
PEAK_FLOPS_TF32 = 495e12       # FLOP/s, dense TF32 on the tensor cores
PEAK_FLOPS_F32 = 67e12         # FLOP/s, f32 outside the tensor cores
HBM_BW = 3.35e12               # bytes/s of device memory
HBM_PER_CHIP = 80 * 10**9      # bytes of device memory (80 GB)
