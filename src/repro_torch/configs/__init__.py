"""Architecture registry of the port (mirrors ``repro.configs``): the
ten archs (five language models, PNA, four recsys models), each
``ArchDef.cell`` of the dry run, and the paper's own index
configuration (``paper_index``)."""
from repro_torch.configs import (bert4rec, dien, gemma3_4b, minicpm3_4b,
                                 mixtral_8x22b, mixtral_8x7b, paper_index,
                                 pna, qwen3_0p6b, sasrec, xdeepfm)
from repro_torch.configs.base import ArchDef, Cell  # noqa: F401

ARCHS = {m.ARCH.arch_id: m.ARCH for m in (
    gemma3_4b, minicpm3_4b, qwen3_0p6b, mixtral_8x7b, mixtral_8x22b,
    pna, sasrec, bert4rec, dien, xdeepfm)}


def get_arch(arch_id: str) -> ArchDef:
    return ARCHS[arch_id]


def list_cells():
    """All 40 (arch x shape) cells, as (arch id, shape id) pairs."""
    return [(a, s) for a, arch in ARCHS.items() for s in arch.shape_ids()]
