"""The paper's own experiment configuration, as a config object.

Captures §4's collection statistics and the evaluation protocol so
benchmarks and examples share one source of truth.
"""
import dataclasses

from repro_torch.core.size_model import PAPER_COLLECTION, CorpusStats
from repro_torch.text.corpus import CorpusSpec


@dataclasses.dataclass(frozen=True)
class PaperIndexConfig:
    collection: CorpusStats = PAPER_COLLECTION
    representations: tuple = ("pr", "or", "cor", "hor")
    query_terms: tuple = (1, 2, 3, 4)        # Table 7 protocol
    query_df_band: tuple = (0.15, 0.5)       # df ~ 300k at D=1M (§4.3)
    topk: int = 10
    repeats: int = 10
    # CPU-runnable tier with the paper's posting-length regime
    bench_spec: CorpusSpec = CorpusSpec(num_docs=20_000, vocab=2_000,
                                        avg_distinct=60, seed=42)


PAPER = PaperIndexConfig()
