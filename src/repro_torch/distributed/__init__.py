"""distributed layer of the PyTorch/CUDA port (mirrors ``repro.distributed``):
the one-controller mesh (``shmap``), the top-k merges (``topk``), the
doc- and term-sharded engines (``retrieval``) and split-K decode
attention (``decode_attn``)."""
from repro_torch.distributed import (decode_attn, retrieval, shmap,  # noqa: F401
                                     topk)
