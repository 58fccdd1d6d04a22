"""text layer of the PyTorch/CUDA port (mirrors ``repro.text``)."""
