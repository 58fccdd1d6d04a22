"""Model layer of the PyTorch/CUDA port (mirrors ``repro.models``): the
shared blocks (``layers``), attention (``attention``: prefill through the
flash kernel on the card, plain decode, MLA) and the decoder-only LM
(``transformer``).  The recsys and GNN models are still to be ported."""
from repro_torch.models import attention, layers, transformer  # noqa: F401
