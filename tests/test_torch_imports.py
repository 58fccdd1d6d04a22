"""Import hygiene of the port: ``repro_torch`` imports neither jax nor
the JAX package, builds nothing at import, and its CUDA launchers refuse
CPU tensors instead of falling back to the plain versions."""
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
        "assert len(mods) >= 21, mods\n"
        "new = {'repro_torch.core.segments',\n"
        "       'repro_torch.core.direct_index',\n"
        "       'repro_torch.kernels.posting_score',\n"
        "       'repro_torch.kernels.packed_postings',\n"
        "       'repro_torch.kernels.embedding_bag',\n"
        "       'repro_torch.kernels.segment_multi_agg',\n"
        "       'repro_torch.kernels.flash_attention'}\n"
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
