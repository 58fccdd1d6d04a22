"""Training layer of the PyTorch/CUDA port (mirrors ``repro.train``):
so far the synthetic data pipelines and the neighbour sampler
(``data``).  The loop, the optimizer, checkpointing and elastic
restarts wait for the port's training path."""
from repro_torch.train import data  # noqa: F401
