"""distributed layer of the PyTorch/CUDA port (mirrors ``repro.distributed``):
the one-controller mesh (``shmap``), the top-k merges (``topk``), the
doc- and term-sharded engines (``retrieval``), split-K decode
attention (``decode_attn``) and int8 gradient compression
(``compress``)."""
from repro_torch.distributed import (compress, decode_attn,  # noqa: F401
                                     retrieval, shmap, topk)
