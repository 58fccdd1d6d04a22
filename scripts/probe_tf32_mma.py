#!/usr/bin/env python3
"""The card's rate for ``mma.sync.m16n8k8`` TF32, the instruction of the
f32 attention kernel's products (``csrc/flash_attention.cu``).

    python3 scripts/probe_tf32_mma.py

Builds a probe kernel with ``nvcc`` into ``build/probe/`` (sm_90a): each
warp issues ``ITERS`` steps of ``CHAINS`` independent ``mma.sync``
products from registers (no memory traffic, no other work), at 4, 8 and
16 warps per SM on every SM.  Prints TFLOP/s (2 * 16 * 8 * 8 per
product), cycles per product per SM sub-partition at the SM clock that
``nvidia-smi`` reads right after, and the card's name and power limit.
Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ITERS, CHAINS = 4096, 8

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
template <int C>
__global__ void probe(float* out, int iters) {
  float d[C][4];
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(1.0f - threadIdx.x * 1e-3f + i);
  for (int c = 0; c < C; ++c)
    for (int e = 0; e < 4; ++e) d[c][e] = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int c = 0; c < C; ++c)
    for (int e = 0; e < 4; ++e) s += d[c][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int probe_launch(float* out, int ctas, int threads, int iters) {
  probe<CHAINS_N><<<ctas, threads>>>(out, iters);
  return (int)cudaGetLastError();
}
""".replace("CHAINS_N", str(CHAINS))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_tf32_mma: no CUDA device", file=sys.stderr)
        return 2
    out_dir = ROOT / "build" / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "probe_tf32_mma.cu"
    src.write_text(SOURCE)
    lib = out_dir / "libprobe_tf32_mma.so"
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib), str(src)],
                   check=True)
    fn = ctypes.CDLL(str(lib)).probe_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smi = ["nvidia-smi", "--format=csv,noheader"]
    card = subprocess.run(smi + ["--query-gpu=name,power.limit"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    for warps in (4, 8, 16):
        threads = 32 * warps
        out = torch.empty(sms * threads, device="cuda")
        for _ in range(2):                       # warm-up, then timed
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            if fn(out.data_ptr(), sms, threads, ITERS):
                raise RuntimeError("probe launch failed")
            stop.record()
            torch.cuda.synchronize()
        ms = start.elapsed_time(stop)
        clock = subprocess.run(smi + ["--query-gpu=clocks.sm"],
                               capture_output=True, text=True).stdout
        mhz = float(clock.split()[0])
        products = sms * warps * ITERS * CHAINS
        tflops = products * 2 * 16 * 8 * 8 / ms / 1e9
        cycles = ms * 1e-3 * mhz * 1e6 / (products / (sms * 4))
        print(f"warps per SM {warps}: {ms:.4f} ms, {tflops:.1f} TFLOP/s, "
              f"{cycles:.2f} cycles per mma.sync per sub-partition at "
              f"{mhz:.0f} MHz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
