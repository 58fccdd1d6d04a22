#!/usr/bin/env python3
"""The packed-block decoder and attention at the smoke's shapes, for any
tree.

    python3 scripts/profile_decode_attention.py [--src DIR] [--seed 7]
        [--only SUBSTRING ...] [--out FILE]

Runs ``unpack_blocks`` and ``flash_attention`` on one GPU.  ``--src``
names the ``src`` directory whose ``repro_torch`` is run (default: this
checkout's), so that the same script reads another tree's kernels;
``--only`` keeps the cases whose name holds one of the substrings.

* ``unpack@synthetic``: 434,816 blocks of 128 lanes, 72 words per block
  (the 1M tier's packed index: ``chip_smoke.py``'s paper phase decodes
  the real one), random words, bit widths drawn from 4-14 (mean 9), a
  twentieth of the blocks partly full.  Held to the plain version to the
  bit; the bound counts each block's ``ceil(128 bits / 32)`` words, its
  metadata and its output at 3.35 TB/s.
* ``attn@<site>``: ``chip_smoke.ATTN_SITES`` (q, k, v from ``--seed``),
  held to the plain version within 2e-4 (f32) or 3e-2 (bf16); and an f32
  case with q and k scaled by ``WIDE`` (logits 30 times wider).

Per case: ``event_ms`` (``chip_smoke.event_ms``, ``REPS`` calls per turn,
two turns) and ``device_ms`` (``chip_smoke.device_ms``, ``TRACED`` calls
after a warm-up, one trace after all event timings).  Prints one JSON
line per case and the card's name and power limit; exits non-zero
without a CUDA device.
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPS, TURNS, TRACED = 20, 2, 3
NB, WPB, BLOCK = 434_816, 72, 128
WIDE = 30.0 ** 0.5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--only", nargs="*", default=None)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_decode_attention: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(a.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import packed_postings as pp

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    logs = cuda_build.build(("unpack_blocks", "flash_attention"))
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas {name}: {line.strip()}")
    card = cs.smi("name,power.limit")
    print(f"card: {card}")

    g = torch.Generator(device=dev).manual_seed(a.seed)
    words = torch.randint(-2**31, 2**31 - 1, (NB, WPB), generator=g,
                          device=dev, dtype=torch.int32)
    bits = torch.randint(4, 15, (NB,), generator=g, device=dev,
                         dtype=torch.int32)
    base = torch.randint(0, 1_000_000, (NB,), generator=g, device=dev,
                         dtype=torch.int32)
    count = torch.full((NB,), BLOCK, dtype=torch.int32, device=dev)
    part = torch.rand(NB, generator=g, device=dev) < 0.05
    count[part] = torch.randint(1, BLOCK, (int(part.sum()),), generator=g,
                                device=dev, dtype=torch.int32)
    cases = {"unpack@synthetic": (pp.unpack_blocks, pp.unpack_blocks_plain,
                                  (words, bits, base, count, BLOCK), {})}
    need = int(((bits.long() * BLOCK + 31) // 32).sum())
    bounds = {"unpack@synthetic": (need * 4 + NB * 12 + NB * BLOCK * 4)
              / cs.HBM_BYTES_PER_S * 1e3}
    for site, (b, hq, hkv, d, window, dt) in cs.ATTN_SITES.items():
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(b, h, cs.ATTN_SEQ, d, generator=g, device=dev)
                   .to(dtype) for h in (hq, hkv, hkv))
        kw = {"causal": True, "window": window}
        cases[site] = (tfa.flash_attention, tfa.flash_attention_plain,
                       (q, k, v), kw)
        live = cs.live_pairs(cs.ATTN_SEQ, window)
        ops = 4 * b * hq * d * live
        # f32 products as three TF32 passes on the tensor cores
        bounds[site] = (ops / cs.BF16_OPS_PER_S if dt == "bfloat16"
                        else 3 * ops / cs.TF32_OPS_PER_S) * 1e3
        if dt == "float32":
            cases[site + "/wide"] = (tfa.flash_attention,
                                     tfa.flash_attention_plain,
                                     (q * WIDE, k * WIDE, v), kw)
            bounds[site + "/wide"] = bounds[site]

    if a.only:
        cases = {k: v for k, v in cases.items()
                 if any(x in k for x in a.only)}
    rows, runs = {}, {}
    for key, (fn, plain, args, kw) in cases.items():
        got = fn(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        if key.startswith("unpack"):
            ok = bool(torch.equal(got, want))
            err = 0.0 if ok else float((got - want).abs().max())
        else:
            tol = 3e-2 if got.dtype == torch.bfloat16 else 2e-4
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            ok = bool((diff <= tol + tol * want.float().abs()).all())
        del got, want
        turns = [cs.event_ms(lambda *c: fn(*c, **kw), [args], REPS)
                 for _ in range(TURNS)]
        rows[key] = {"case": key, "ok": ok, "max_abs_err": err,
                     "event_ms_turns": turns, "bound_ms": bounds[key]}
        kern = "unpack_blocks" if key.startswith("unpack") \
            else "flash_attention"
        runs[key] = (kern, functools.partial(fn, **kw),
                     [args] * (1 + TRACED), 1)
    dev_ms = cs.device_ms(runs)
    failed = False
    for key, row in rows.items():
        row["device_ms"] = dev_ms.get(key)
        row["card"] = card
        print(f"case: {json.dumps(row)}")
        failed |= not row["ok"]
    if a.out:
        Path(a.out).write_text(json.dumps(list(rows.values()), indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
