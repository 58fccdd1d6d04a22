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
        "assert len(mods) >= 14, mods\n"
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
