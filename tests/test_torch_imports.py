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
        "assert len(mods) >= 18, mods\n"
        "new = {'repro_torch.core.segments',\n"
        "       'repro_torch.core.direct_index',\n"
        "       'repro_torch.kernels.posting_score',\n"
        "       'repro_torch.kernels.packed_postings'}\n"
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
