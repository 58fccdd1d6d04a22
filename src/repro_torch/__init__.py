"""PyTorch/CUDA port of ``repro``: the paper's query path on an NVIDIA
Hopper GPU.  Module paths mirror ``repro``'s; the fused candidate
kernels are hand-written CUDA C++ (``kernels/csrc``).  Imports torch and
numpy only — never jax, never ``repro``."""
