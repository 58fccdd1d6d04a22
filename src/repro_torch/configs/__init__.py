"""Architecture registry of the port (mirrors ``repro.configs``): the
five language-model archs and the paper's own index configuration
(``paper_index``).  The recsys and GNN archs, ``Cell`` and
``list_cells`` wait for their models and the training path."""
from repro_torch.configs import (gemma3_4b, minicpm3_4b, mixtral_8x22b,
                                 mixtral_8x7b, paper_index, qwen3_0p6b)
from repro_torch.configs.base import ArchDef  # noqa: F401

ARCHS = {m.ARCH.arch_id: m.ARCH for m in (
    gemma3_4b, minicpm3_4b, qwen3_0p6b, mixtral_8x7b, mixtral_8x22b)}


def get_arch(arch_id: str) -> ArchDef:
    return ARCHS[arch_id]
