"""Import hygiene of the port: ``repro_torch`` imports neither jax nor
the JAX package, builds nothing at import, and its CUDA launchers refuse
CPU tensors instead of falling back to the plain versions."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 60, mods\n"
        "new = {'repro_torch.core.segments',\n"
        "       'repro_torch.core.direct_index',\n"
        "       'repro_torch.kernels.posting_score',\n"
        "       'repro_torch.kernels.packed_postings',\n"
        "       'repro_torch.kernels.embedding_bag',\n"
        "       'repro_torch.kernels.segment_multi_agg',\n"
        "       'repro_torch.kernels.flash_attention',\n"
        "       'repro_torch.serve', 'repro_torch.serve.cache',\n"
        "       'repro_torch.serve.maintenance',\n"
        "       'repro_torch.serve.metrics', 'repro_torch.serve.server',\n"
        "       'repro_torch.serve.snapshot', 'repro_torch.launch',\n"
        "       'repro_torch.launch.serve',\n"
        "       'repro_torch.models.layers', 'repro_torch.models.attention',\n"
        "       'repro_torch.models.transformer',\n"
        "       'repro_torch.distributed.decode_attn',\n"
        "       'repro_torch.configs.base', 'repro_torch.configs.paper_index',\n"
        "       'repro_torch.configs.qwen3_0p6b',\n"
        "       'repro_torch.configs.gemma3_4b',\n"
        "       'repro_torch.configs.minicpm3_4b',\n"
        "       'repro_torch.configs.mixtral_8x7b',\n"
        "       'repro_torch.configs.mixtral_8x22b',\n"
        "       'repro_torch.models.gnn', 'repro_torch.models.recsys',\n"
        "       'repro_torch.configs.pna', 'repro_torch.configs.sasrec',\n"
        "       'repro_torch.configs.bert4rec', 'repro_torch.configs.dien',\n"
        "       'repro_torch.configs.xdeepfm', 'repro_torch.train',\n"
        "       'repro_torch.train.data', 'repro_torch.train.optimizer',\n"
        "       'repro_torch.train.checkpoint', 'repro_torch.train.loop',\n"
        "       'repro_torch.core.tree', 'repro_torch.launch.train'}\n"
        "assert new <= set(mods), sorted(new - set(mods))\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    build = SRC.parent / "build" / "kernels"
    assert not build.exists() or not any(build.glob("*.tmp"))


def test_cuda_launchers_refuse_cpu_tensors():
    from repro_torch.kernels import fused_decode_score as fds
    i32 = dict(dtype=torch.int32)
    f32 = dict(dtype=torch.float32)
    pairs = (torch.zeros(8, **i32), torch.full((8,), 1, **i32),
             torch.zeros(8, 8, **f32), torch.zeros(8, **i32))
    meta = (torch.ones(600, **f32), torch.zeros(600, **f32),
            torch.ones(8, **f32))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fds._launch_blocked_cuda(
            torch.zeros(4, 128, **i32), torch.zeros(4, 128, **f32), *pairs,
            *meta, 600, 16, 0.0, 512)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fds._launch_packed_cuda(
            torch.zeros(4, 8, **i32), torch.zeros(4, 128,
                                                  dtype=torch.float16),
            *pairs, torch.ones(8, **i32), torch.zeros(8, **i32),
            torch.zeros(8, **i32), *meta, 600, 16, 0.0, 512)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fds._launch_score_blocked_cuda(
            torch.zeros(4, 128, **i32), torch.zeros(4, 128, **f32), *pairs,
            600, 512)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fds._launch_score_packed_cuda(
            torch.zeros(4, 8, **i32), torch.zeros(4, 128,
                                                  dtype=torch.float16),
            *pairs, torch.ones(8, **i32), torch.zeros(8, **i32),
            torch.zeros(8, **i32), 600, 512)
    # the wrappers send CPU tensors to the plain versions
    out = fds.fused_score_blocked(torch.zeros(4, 128, **i32),
                                  torch.zeros(4, 128, **f32), *pairs, 600)
    assert out.shape == (8, 600) and not out.any()
    for name in ("fused_topk_blocked", "fused_topk_packed",
                 "fused_score_blocked", "fused_score_packed"):
        assert getattr(fds, name).launches == 0


@pytest.mark.parametrize("bad", ["pair_cap", "norm", "qnorm", "block_tfs",
                                 "empty_words"])
def test_cuda_launchers_check_shapes(bad):
    """Every extent the kernels trust is checked before any pointer is
    taken: a short pair array, a doc table that is not num_docs long, a
    qnorm that is not Q long, tfs that do not match the blocks, packed
    blocks with no words — in the candidate and the dense launchers."""
    from repro_torch.kernels import fused_decode_score as fds
    i32 = dict(dtype=torch.int32)
    f32 = dict(dtype=torch.float32)
    t = dict(pair_block=torch.zeros(8, **i32),
             pair_tile=torch.ones(8, **i32),
             pair_qw=torch.zeros(8, 8, **f32),
             pair_cap=torch.zeros(8 - (bad == "pair_cap"), **i32),
             norm=torch.ones(600 - (bad == "norm"), **f32),
             rank=torch.zeros(600, **f32),
             qnorm=torch.ones(8 + (bad == "qnorm"), **f32))
    pairs = [t[k] for k in ("pair_block", "pair_tile", "pair_qw", "pair_cap")]
    meta = [t[k] for k in ("norm", "rank", "qnorm")]
    tf_rows = 4 - (bad == "block_tfs")
    words = 0 if bad == "empty_words" else 8
    with pytest.raises(ValueError, match="has shape"):
        fds._launch_packed_cuda(
            torch.zeros(4, words, **i32),
            torch.zeros(tf_rows, 128, dtype=torch.float16), *pairs,
            torch.ones(8, **i32), torch.zeros(8, **i32),
            torch.zeros(8, **i32), *meta, 600, 16, 0.0, 512)
    dense = bad not in ("norm", "qnorm")   # the dense kernels take no meta
    if dense:
        with pytest.raises(ValueError, match="has shape"):
            fds._launch_score_packed_cuda(
                torch.zeros(4, words, **i32),
                torch.zeros(tf_rows, 128, dtype=torch.float16), *pairs,
                torch.ones(8, **i32), torch.zeros(8, **i32),
                torch.zeros(8, **i32), 600, 512)
    if bad != "empty_words":
        with pytest.raises(ValueError, match="has shape"):
            fds._launch_blocked_cuda(
                torch.zeros(4, 128, **i32), torch.zeros(tf_rows, 128, **f32),
                *pairs, *meta, 600, 16, 0.0, 512)
    if dense and bad != "empty_words":
        with pytest.raises(ValueError, match="has shape"):
            fds._launch_score_blocked_cuda(
                torch.zeros(4, 128, **i32), torch.zeros(tf_rows, 128, **f32),
                *pairs, 600, 512)


def test_side_launchers_refuse_cpu_tensors():
    from repro_torch.kernels import packed_postings as tpp
    from repro_torch.kernels import posting_score as tps
    i32 = dict(dtype=torch.int32)
    f32 = dict(dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tps._launch_posting_score_cuda(
            torch.zeros(4, 16, **i32), torch.zeros(4, 16, **f32),
            torch.zeros(8, **i32), torch.ones(8, **i32),
            torch.zeros(8, **f32), 600, 512)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tpp._launch_unpack_cuda(torch.zeros(4, 8, **i32),
                                torch.ones(4, **i32), torch.zeros(4, **i32),
                                torch.zeros(4, **i32), 128)
    assert tps.posting_score.launches == 0
    assert tpp.unpack_blocks.launches == 0


@pytest.mark.parametrize("bad", ["block_docs", "block_tfs", "pair_block",
                                 "pair_tile", "pair_w", "tile"])
def test_posting_score_launcher_checks_extents(bad):
    """Each tensor the posting scorer reads is checked before any
    pointer is taken: one wrong extent per case, and a tile whose
    accumulator cannot fit in shared memory."""
    from repro_torch.kernels import posting_score as tps
    i32 = dict(dtype=torch.int32)
    f32 = dict(dtype=torch.float32)
    args = [torch.zeros(4, 16, **i32), torch.zeros(4, 16, **f32),
            torch.zeros(8, **i32), torch.ones(8, **i32),
            torch.zeros(8, **f32)]
    wrong = {"block_docs": torch.zeros(4, 16, 1, **i32),
             "block_tfs": torch.zeros(4, 17, **f32),
             "pair_block": torch.zeros(9, **i32),
             "pair_tile": torch.ones(7, **i32),
             "pair_w": torch.zeros(8, 2, **f32)}
    names = ["block_docs", "block_tfs", "pair_block", "pair_tile", "pair_w"]
    if bad in wrong:
        args[names.index(bad)] = wrong[bad]
    tile = 2**16 if bad == "tile" else 512
    with pytest.raises(ValueError, match="has shape|shared memory"):
        tps._launch_posting_score_cuda(*args, 600, tile)


@pytest.mark.parametrize("bad", ["packed", "bits", "base", "count",
                                 "block_0", "block_1025"])
def test_unpack_launcher_checks_extents(bad):
    """Each tensor the decoder reads is checked before any pointer is
    taken (packed blocks with no words included), and a block width the
    kernel does not decode (past 1024 lanes, or none) raises instead of
    falling back."""
    from repro_torch.kernels import packed_postings as tpp
    i32 = dict(dtype=torch.int32)
    packed = torch.zeros(4, 0 if bad == "packed" else 8, **i32)
    bits = torch.ones(4 + (bad == "bits"), **i32)
    base = torch.zeros(4 - (bad == "base"), **i32)
    count = torch.zeros(4 if bad != "count" else 5, **i32)
    block = {"block_0": 0, "block_1025": 1025}.get(bad, 128)
    with pytest.raises(ValueError, match="has shape|lanes"):
        tpp._launch_unpack_cuda(packed, bits, base, count, block)


def test_model_launchers_refuse_cpu_tensors():
    """The three model kernels' launchers refuse CPU tensors; their
    wrappers send CPU tensors to the plain versions and count nothing."""
    from repro_torch.kernels import embedding_bag as tbag
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import segment_multi_agg as tpna
    table = torch.zeros(50, 10)
    idx = torch.zeros(4, 3, dtype=torch.int32)
    q = torch.zeros(1, 4, 32, 16)
    kv = torch.zeros(1, 2, 32, 16)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tbag._launch_embedding_bag_cuda(table, idx)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tpna._launch_pna_cuda(table, idx)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tfa._launch_flash_cuda(q, kv, kv, True, 0)
    assert tbag.embedding_bag(table, idx).shape == (4, 10)
    assert tpna.pna_multi_agg(table, idx).shape == (4, 40)
    assert tfa.flash_attention(q, kv, kv).shape == q.shape
    for fn in (tbag.embedding_bag, tpna.pna_multi_agg, tfa.flash_attention):
        assert fn.launches == 0


@pytest.mark.parametrize("bad", ["table_dtype", "table_rank", "idx_dtype",
                                 "idx_rank", "idx_range"])
def test_embedding_bag_launcher_checks(bad):
    """Wrong dtypes or ranks, and an id past the table's last row (the
    kernel reads rows unchecked), raise before any pointer is taken."""
    from repro_torch.kernels import embedding_bag as tbag
    table = {"table_dtype": torch.zeros(50, 10, dtype=torch.float16),
             "table_rank": torch.zeros(50, 10, 1)}.get(bad,
                                                     torch.zeros(50, 10))
    idx = {"idx_dtype": torch.zeros(4, 3, dtype=torch.int64),
           "idx_rank": torch.zeros(12, dtype=torch.int32),
           "idx_range": torch.tensor([[0, -1, 49], [50, 1, -1]],
                                     dtype=torch.int32)}.get(
        bad, torch.zeros(4, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="is torch|needed|id 50, past"):
        tbag._launch_embedding_bag_cuda(table, idx)


@pytest.mark.parametrize("bad", ["feats_dtype", "feats_rank", "nbr_dtype",
                                 "nbr_range"])
def test_pna_launcher_checks(bad):
    """Wrong dtypes or ranks, and a neighbour past the last feature row
    (the kernel reads rows unchecked), raise before any pointer is
    taken."""
    from repro_torch.kernels import segment_multi_agg as tpna
    feats = {"feats_dtype": torch.zeros(50, 8, dtype=torch.bfloat16),
             "feats_rank": torch.zeros(50)}.get(bad, torch.zeros(50, 8))
    nbr = torch.zeros(4, 3, dtype=torch.int64 if bad == "nbr_dtype"
                      else torch.int32)
    if bad == "nbr_range":
        nbr[2, 1] = 50
    with pytest.raises(ValueError, match="needs torch|needed|id 50, past"):
        tpna._launch_pna_cuda(feats, nbr)


def _record_launch(monkeypatch, module):
    """Let ``module``'s CUDA launcher run on CPU tensors up to its C
    call, which is recorded instead of made: (argtypes, arguments)."""
    calls = []
    monkeypatch.setattr(module, "tensors_ok", lambda dev, specs: True)
    monkeypatch.setattr(module, "entry", lambda name, argtypes: (
        lambda *args: calls.append((argtypes, args)) or 0))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda dev: 0, raising=False)
    return calls


@pytest.mark.parametrize("kernel", ["embedding_bag", "pna_multi_agg"])
def test_gather_launchers_pass_rows_past_int32(monkeypatch, kernel):
    """A table of 2^31 rows or more reaches the kernel's range check
    with its row count whole, not wrapped to a negative C int (which
    would refuse every id)."""
    import ctypes

    from repro_torch.kernels import embedding_bag as tbag
    from repro_torch.kernels import segment_multi_agg as tpna
    module, launcher = {
        "embedding_bag": (tbag, tbag._launch_embedding_bag_cuda),
        "pna_multi_agg": (tpna, tpna._launch_pna_cuda)}[kernel]
    calls = _record_launch(monkeypatch, module)
    rows = 2**31 + 5
    table = torch.zeros(1, 4).expand(rows, 4)      # no storage of that size
    launcher(table, torch.zeros(2, 3, dtype=torch.int32))
    (argtypes, args), = calls
    assert args[6] == rows                         # table, ids, out, 3 ints
    assert argtypes[6](args[6]).value == rows


def test_embedding_bag_launcher_refuses_batch_past_int32(monkeypatch):
    """The bag kernel indexes its output with 32-bit ints: a batch whose
    B x D reaches ``OUT_LIMIT`` is refused by name before any launch."""
    from repro_torch.kernels import embedding_bag as tbag
    calls = _record_launch(monkeypatch, tbag)
    bags = tbag.OUT_LIMIT // 8
    idx = torch.zeros(1, 1, dtype=torch.int32).expand(bags, 1)
    with pytest.raises(ValueError, match=rf"\[{bags}, 8\] output reaches "
                                         r"2\^31 - 2\^15 elements"):
        tbag._launch_embedding_bag_cuda(torch.zeros(4, 8), idx)
    assert not calls


@pytest.mark.parametrize("bad", ["head_dim", "groups", "k_shape", "v_dtype",
                                 "q_dtype", "rank"])
def test_flash_launcher_checks(bad):
    """Head widths the kernel is not built for, Hq not a multiple of Hkv,
    K/V shapes unlike q's, mixed or unsupported dtypes and wrong ranks
    raise before any pointer is taken."""
    from repro_torch.kernels import flash_attention as tfa
    d = 48 if bad == "head_dim" else 16
    q = torch.zeros(1, 4, 32, d, dtype=torch.float16 if bad == "q_dtype"
                    else torch.float32)
    k = torch.zeros(1, 3 if bad == "groups" else 2, 32, d)
    v = k.clone()
    if bad == "k_shape":
        k = torch.zeros(1, 2, 31, d)
    if bad == "v_dtype":
        v = v.to(torch.bfloat16)
    if bad == "rank":
        q = q[0]
    with pytest.raises(ValueError, match="head width|multiple|has shape|"
                                         "is torch|needed"):
        tfa._launch_flash_cuda(q, k, v, True, 0)


# names of the reference's packages with no counterpart in the port: the
# kernel modules hold their own plain versions (``ref``), and the
# interpret-mode switch serves only jax
NO_COUNTERPART = {"kernels": {"ref", "runtime"}}
# names whose modules ROADMAP lists as still to be ported (the seed
# scaffolding)
WAITING = {"distributed": {"compress"},
           "launch": {"hw", "mesh", "sharding"},
           "configs": {"Cell"},
           "train": {"elastic"}}


def _package_names(package: str) -> set:
    """The public names of ``package`` right after a fresh interpreter
    imports it: its ``__all__``, else every name without a leading
    underscore (the submodules it imports included)."""
    code = (
        "import importlib, json\n"
        f"m = importlib.import_module({package!r})\n"
        "names = getattr(m, '__all__', None) or [\n"
        "    n for n in dir(m) if not n.startswith('_')]\n"
        "print(json.dumps(sorted(names)))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


@pytest.mark.parametrize("package", ["core", "text", "obs", "kernels",
                                     "serve", "distributed", "launch",
                                     "models", "configs", "train"])
def test_package_names_cover_the_reference(package):
    """Each port package exports the reference package's public names,
    from the port's own modules, but for those with no counterpart and
    those still waiting for their modules; and every import order of the
    packages works from a fresh interpreter (``core`` and ``kernels.ops``
    import each other's modules)."""
    ref = _package_names(f"repro.{package}")
    port = _package_names(f"repro_torch.{package}")
    assert ref - port == NO_COUNTERPART.get(package, set()) | \
        WAITING.get(package, set())
    code = {"core": "from repro_torch.core import (bulk_build, make_scorer, "
                    "BlockedIndex, size_model)",
            "text": "from repro_torch.text import CorpusSpec, PAPER_SPEC",
            "obs": "from repro_torch.obs import GLOBAL, Tracer",
            "kernels": "import repro_torch.kernels.ops; "
                       "from repro_torch.kernels import ops",
            "serve": "from repro_torch.serve import QueryServer, MeshServer",
            "distributed": "from repro_torch.distributed import topk, "
                           "retrieval, shmap, decode_attn",
            "launch": "import repro_torch.launch.serve",
            "models": "from repro_torch.models import transformer, "
                      "attention, layers, gnn, recsys",
            "configs": "from repro_torch.configs import ARCHS, get_arch, "
                       "ArchDef, paper_index, list_cells, pna, xdeepfm",
            "train": "from repro_torch.train import data; "
                     "from repro_torch.train.data import NeighborSampler; "
                     "from repro_torch.train import checkpoint, loop, "
                     "optimizer; import repro_torch.launch.train"
            }[package]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
