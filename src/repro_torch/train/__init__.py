"""Training layer of the PyTorch/CUDA port (mirrors ``repro.train``):
the synthetic data pipelines and the neighbour sampler (``data``), AdamW
and the pure train step (``optimizer``), atomic checkpoints in the
reference's format (``checkpoint``) and the fault-tolerant loop
(``loop``), and the elastic restore onto a mesh (``elastic``);
``core.tree`` flattens their trees in JAX's leaf order."""
from repro_torch.train import (checkpoint, data, elastic,  # noqa: F401
                               loop, optimizer)
