"""Model layer of the PyTorch/CUDA port (mirrors ``repro.models``): the
shared blocks (``layers``), attention (``attention``: prefill through the
flash kernel on the card, plain decode, MLA), the decoder-only LM
(``transformer``), the recsys models (``recsys``: xDeepFM's lookups
through the bag kernel) and PNA (``gnn``: its aggregations through the
PNA kernel)."""
from repro_torch.models import (attention, gnn, layers, recsys,  # noqa: F401
                                transformer)
