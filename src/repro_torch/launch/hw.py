"""Target-hardware constants of the port: one NVIDIA H100 SXM (80 GB
HBM3), from NVIDIA's data sheet, for the kernels' bounds and the dry
run's fit.  The reference's ``repro.launch.hw`` holds a TPU's; these
replace them, with shared memory per SM in place of VMEM per core.

``CHIPS_PER_POD`` and ``PODS`` shape the dry run's production meshes
(16 x 16, and 2 x 16 x 16), not this card."""

PEAK_FLOPS_BF16 = 989e12       # FLOP/s, dense bf16 on the tensor cores
PEAK_FLOPS_TF32 = 495e12       # FLOP/s, dense TF32 on the tensor cores
PEAK_FLOPS_F32 = 67e12         # FLOP/s, f32 outside the tensor cores
HBM_BW = 3.35e12               # bytes/s of device memory
ICI_BW = 450e9                 # bytes/s a direction of NVLink 4 (900 GB/s
                               # both ways) per card
HBM_PER_CHIP = 80 * 10**9      # bytes of device memory (80 GB)
SMEM_PER_SM = 228 * 2**10      # bytes of shared memory per SM

CHIPS_PER_POD = 256            # 16 x 16 single-pod mesh
PODS = 2
