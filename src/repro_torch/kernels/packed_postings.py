"""Packed-block decoder: the port of ``repro.kernels.packed_postings``.

The beyond-paper ``PackedCsrIndex`` stores doc-id deltas bit-packed into
u32 words (held as int32 bit-views), the "special number encodings" the
paper says DBMSs lack (§3.1).  ``unpack_blocks`` decodes a batch of
blocks to i32 doc ids: per-lane shifts and masks, then an in-block
prefix sum from the block's base; lanes at or past a block's count get
-1.

* ``unpack_blocks``' CUDA C++ kernel (``csrc/unpack_blocks.cu``) shares
  its decode with the fused packed kernels (``csrc/tile_accumulate.cuh``)
  and takes blocks of 1 to 1024 lanes; a CUDA tensor always goes to it,
  and a wider block raises.  There is no fallback.
* ``unpack_blocks_plain`` is its plain PyTorch version, the path for CPU
  tensors and the kernel's yardstick on the card: the vectorized decode
  of ``core.layouts.unpack_words``, which computes the same function.

``unpack_blocks.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.layouts import unpack_words
from repro_torch.kernels.cuda_build import check_tensors, launch

Tensor = torch.Tensor

MAX_BLOCK = 1024   # lanes per block the CUDA kernel decodes (one thread each)


def unpack_blocks_plain(packed: Tensor, bits: Tensor, base: Tensor,
                        count: Tensor, block: int) -> Tensor:
    """Plain PyTorch version of the decoder: i32[NB, block]."""
    return unpack_words(packed, bits, base, count, block)


_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature (csrc/unpack_blocks.cu): words, wpb, bits, base, count, out,
# nb, block, stream
_ARGTYPES = [_P, _I, _P, _P, _P, _P, _I, _I, _P]


def _launch_unpack_cuda(packed, bits, base, count, block: int) -> Tensor:
    """Check every tensor the kernel reads and the block width, then
    launch it."""
    name = "unpack_blocks"
    if not 1 <= block <= MAX_BLOCK:
        raise ValueError(f"{name}: block={block}, the CUDA kernel decodes "
                         f"blocks of 1 to {MAX_BLOCK} lanes")
    nb, wpb = packed.shape[0], packed.shape[-1]
    i32 = torch.int32
    check_tensors(name, packed=(packed, i32, (nb, max(wpb, 1))),
                  bits=(bits, i32, (nb,)), base=(base, i32, (nb,)),
                  count=(count, i32, (nb,)))
    out = torch.empty((nb, block), dtype=i32, device=packed.device)
    if nb:
        launch(name, _ARGTYPES, (packed, wpb, bits, base, count, out, nb,
                                 block), packed.device)
    return out


def unpack_blocks(packed: Tensor, bits: Tensor, base: Tensor, count: Tensor,
                  block: int) -> Tensor:
    """Decode packed blocks (replaces ``unpack_blocks_pallas``): packed
    i32[NB, Wpb] u32 bit-views, bits/base/count i32[NB] -> doc ids
    i32[NB, block].  CUDA tensors launch the kernel; CPU tensors take the
    plain version."""
    if not packed.is_cuda:
        return unpack_blocks_plain(packed, bits, base, count, block)
    out = _launch_unpack_cuda(packed, bits, base, count, block)
    unpack_blocks.launches += 1
    return out


unpack_blocks.launches = 0
