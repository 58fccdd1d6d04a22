"""core layer of the PyTorch/CUDA port (mirrors ``repro.core``): the
paper's index storage layouts and query evaluation, with the reference
package's names."""
from repro_torch.core.layouts import (  # noqa: F401
    BLOCK, BlockedIndex, CompactCsrIndex, CooIndex, CsrIndex, DocTable,
    PackedCsrIndex, PostingsHost, REPRESENTATIONS, build_blocked,
    build_compact_csr, build_coo, build_csr, build_packed_csr,
)
# the kernels package before ``core.query``: ``kernels.ops`` imports the
# query module whole, and ``core.query`` reaches ``kernels.cuda_build``
import repro_torch.kernels  # noqa: F401,E402
from repro_torch.core.build import (  # noqa: F401,E402
    TokenizedCorpus, add_documents, bulk_build, corpus_stats)
from repro_torch.core.direct_index import (  # noqa: F401,E402
    DirectIndex, build_direct, expand_query)
from repro_torch.core.query import (  # noqa: F401,E402
    QueryResult, make_scorer, score_queries, score_query)
from repro_torch.core import size_model  # noqa: F401,E402
