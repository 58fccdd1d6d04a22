"""obs layer of the PyTorch/CUDA port (mirrors ``repro.obs``)."""
