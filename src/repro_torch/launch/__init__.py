"""Launchers of the PyTorch/CUDA port (mirrors ``repro.launch``)."""
