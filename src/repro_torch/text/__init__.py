"""text layer of the PyTorch/CUDA port (mirrors ``repro.text``)."""
from repro_torch.text.corpus import (  # noqa: F401
    CorpusSpec, PAPER_SPEC, generate, sample_query_terms)
from repro_torch.text.tokenizer import (  # noqa: F401
    fnv1a, hash_terms, mix32, stem, tokenize)
