"""Training layer of the PyTorch/CUDA port (mirrors ``repro.train``):
the synthetic data pipelines and the neighbour sampler (``data``), AdamW
and the pure train step (``optimizer``), atomic checkpoints in the
reference's format (``checkpoint``) and the fault-tolerant loop
(``loop``); ``core.tree`` flattens their trees in JAX's leaf order.
Elastic re-meshing (``elastic``) waits for the port's meshes."""
from repro_torch.train import (checkpoint, data, loop,  # noqa: F401
                               optimizer)
