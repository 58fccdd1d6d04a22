"""distributed layer of the PyTorch/CUDA port (mirrors ``repro.distributed``):
the one-controller mesh (``shmap``), the top-k merges (``topk``) and the
doc- and term-sharded engines (``retrieval``)."""
from repro_torch.distributed import retrieval, shmap, topk  # noqa: F401
