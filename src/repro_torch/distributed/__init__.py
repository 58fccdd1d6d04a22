"""distributed layer of the PyTorch/CUDA port (mirrors ``repro.distributed``)."""
from repro_torch.distributed import topk  # noqa: F401
