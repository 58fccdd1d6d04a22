"""kernels layer of the PyTorch/CUDA port (mirrors ``repro.kernels``).
The package exports ``ops``; the reference's ``ref`` has no counterpart,
since each kernel module holds its own plain version."""
from repro_torch.kernels import ops  # noqa: F401
