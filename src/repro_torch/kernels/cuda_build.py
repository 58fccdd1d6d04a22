"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``.  The
build happens at first use, from the sources in the repository only,
into ``build/kernels/`` at the repository root (or
``$REPRO_TORCH_BUILD_DIR``); the library's name carries a hash of its
sources and flags, so an edited source never loads a stale build.
Nothing is built when a module is imported: the CPU tests import every
module on machines without ``nvcc``.

``-fmad=false`` keeps the compiler from contracting any ``a*b + c`` on
its own: the kernels ask for each fused multiply-add they mean
(``__fmaf_rn``), where the reference's XLA lowering has one.  There is
no ``--use_fast_math``: division stays IEEE.  ``flash_attention`` also
links the driver library (``-lcuda``, through the toolkit's stub), for
the TMA descriptors it encodes on the host.

A launch goes through ``entry``: each kernel's C function is looked up
and typed once per process, and ``launch`` passes it the data pointers
and the raw handle of PyTorch's current stream, so that a call of a few
microseconds of device work is not paid for by the host's lookups.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("fused_topk_blocked", "fused_topk_packed", "fused_score_blocked",
           "fused_score_packed", "posting_score", "unpack_blocks",
           "embedding_bag", "pna_multi_agg", "flash_attention",
           "query_weights")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# per-kernel link flags, after the source
LINK = {"flash_attention": ("-lcuda",)}

_FNS: dict = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built "
            "from source at first use")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK.get(name, ())).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, str]:
    """Compile every kernel in ``names`` that has no current build, one
    ``nvcc`` process per source, all started together.  Returns each
    kernel's ``ptxas -v`` report (registers, shared memory, spills) for
    the kernels built by this call.  Raises if any build fails."""
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        if name in LINK:
            stubs = Path(nvcc()).parents[1] / "lib64" / "stubs"
            cmd += ["-L", str(stubs), *LINK[name]]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n{logs[name]}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def entry(name: str, argtypes, symbol: str | None = None):
    """Kernel ``name``'s C function ``symbol`` (by default its entry point
    ``<name>_launch``, which returns the ``cudaError_t`` of its launch),
    taking ``argtypes`` and returning an int: built first if needed,
    loaded and typed once per process."""
    symbol = symbol or f"{name}_launch"
    fn = _FNS.get(symbol)
    if fn is None:
        path = _lib_path(name)
        if not path.exists():
            build((name,))
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[symbol] = fn
    return fn


def check_tensors(name: str, **tensors) -> None:
    """Validate each ``arg=(tensor, dtype, shape)`` before its pointer
    reaches kernel ``name``, which trusts every extent it is given:
    shapes and dtypes first, then one CUDA device and contiguity."""
    for arg, (t, dtype, shape) in tensors.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"needs {tuple(shape)}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: {arg} is {t.dtype}, needs {dtype}")
    dev = None
    for arg, t in ((a, v[0]) for a, v in tensors.items()):
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} is on {t.device}; the CUDA "
                             "kernel takes CUDA tensors only")
        if dev is None:
            dev = t.device
        if t.device != dev:
            raise ValueError(f"{name}: {arg} on {t.device}, others on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def tensors_ok(dev: int, specs) -> bool:
    """One pass over ``(tensor, dtype, shape)`` specs: True when every
    tensor is contiguous, on CUDA device ``dev``, with that dtype and
    shape.  The launchers' fast check; on False they call
    ``check_tensors``, which names the tensor at fault."""
    for t, dtype, shape in specs:
        if not (t.dtype == dtype and t.shape == shape
                and t.get_device() == dev and t.is_contiguous()):
            return False
    return dev >= 0


def refuse_grad(name: str, *tensors) -> None:
    """A kernel writes a fresh tensor that autograd cannot see: refuse an
    input that requires grad (outside ``torch.no_grad``), where the
    gradient would silently be lost.  ``kernels.ops``' entry points carry
    the gradient through a ``torch.autograd.Function``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(f"{name}: an input requires grad and the raw "
                         f"launch has no backward; call kernels.ops, whose "
                         f"autograd Function carries the gradient")


def check_ids(name: str, arg: str, ids, rows: int) -> None:
    """Refuse an id past the ``rows`` rows it indexes (a negative id is
    padding), reading ``ids.max()`` back: for host tensors only, since
    the read synchronises; the gather kernels check their CUDA ids
    themselves and trap on one past the table."""
    top = int(ids.max()) if ids.numel() else -1
    if top >= rows:
        raise ValueError(f"{name}: {arg} holds id {top}, past the {rows} "
                         "rows it indexes")


def launch(name: str, argtypes, args, device) -> None:
    """Call kernel ``name``'s C entry point with ``args`` (tensors passed
    as their data pointers, numbers as given) and the raw handle of the
    current stream of ``device``; raises if the launch is refused (a
    ``cudaError_t``, or 10000 + a driver ``CUresult``)."""
    vals = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = entry(name, argtypes)(
        *vals, torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (error {err})")
