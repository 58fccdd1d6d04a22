"""distributed layer of the PyTorch/CUDA port (mirrors ``repro.distributed``)."""
