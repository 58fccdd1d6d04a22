"""Training launcher: ``python -m repro_torch.launch.train --arch
qwen3-0.6b`` (the port of ``repro.launch.train``).

Runs a real training loop (synthetic data) for any registered arch on
``--device`` (``cuda`` unless asked otherwise): smoke scale by default,
the published widths with ``--scale full``.  Exercises the whole stack:
config -> model -> optimizer -> train step -> checkpoint/restart.

On the card the run is made repeatable: torch's deterministic algorithms
are switched on (``deterministic``), and every segment sum and every
scatter of the model kernels' backward rules adds in a fixed order.

Differences from the reference, by design: ``--device`` (the reference
runs on whatever JAX devices exist); the step is not compiled or
sharded, and nothing is donated (the step is pure); ``main`` takes
``argv`` and returns an exit code (0 when the last loss is finite), and
``run`` returns the loop's result.
"""
from __future__ import annotations

import argparse
import logging
import math
import os

import numpy as np
import torch


def deterministic() -> None:
    """Make the card's ops repeat bit for bit: torch's deterministic
    algorithms (warning, not raising, where an op has none), and the
    cuBLAS workspace setting they need (read when cuBLAS starts, so set
    it before the first product)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)


def make_batch_fn(arch, cfg, shp, seed: int):
    """``step -> batch`` (host numpy) for the arch's train shape, as the
    reference's launcher makes it."""
    from repro_torch.train import data as data_lib
    kind = arch.kind
    aid = arch.arch_id
    if kind == "lm":
        b, s = shp["batch"], shp["seq"]
        return lambda step: data_lib.lm_batch(seed, step, b, s, cfg.vocab)
    if kind == "gnn":
        if shp.get("graph_level"):
            return lambda step: data_lib.molecule_batch(
                seed, step, shp["n_graphs"],
                shp["n_nodes"] // shp["n_graphs"],
                shp["n_edges"] // shp["n_graphs"], cfg.d_feat,
                cfg.n_classes)
        g = data_lib.make_synthetic_graph(shp["n_nodes"], shp["n_edges"],
                                          cfg.d_feat, cfg.n_classes, seed)
        full = data_lib.fullgraph_batch(g, seed=seed)
        return lambda step: full
    if aid == "sasrec":
        return lambda step: data_lib.sasrec_batch(
            seed, step, shp["batch"], cfg.seq_len, cfg.n_items,
            cfg.n_negatives)
    if aid == "bert4rec":
        return lambda step: data_lib.bert4rec_batch(
            seed, step, shp["batch"], cfg.seq_len, cfg.n_items,
            cfg.n_negatives)
    if aid == "dien":
        return lambda step: data_lib.dien_batch(
            seed, step, shp["batch"], cfg.seq_len, cfg.n_items)
    return lambda step: data_lib.xdeepfm_batch(
        seed, step, shp["batch"], cfg.n_fields, cfg.field_vocab, cfg.n_hot)


def model_fns(arch, cfg, shp, seed, device):
    """(params, loss_fn) of the arch: params drawn from ``seed`` on
    ``device``."""
    from repro_torch.configs import base
    from repro_torch.models import gnn as gnn_lib
    from repro_torch.models import transformer as tfm
    if arch.kind == "lm":
        return (tfm.init_params(seed, cfg, device=device),
                lambda p, b: tfm.loss_fn(p, cfg, b))
    if arch.kind == "gnn":
        lfn = gnn_lib.graph_loss if shp.get("graph_level") else \
            gnn_lib.node_loss
        return (gnn_lib.init_params(seed, cfg, device=device),
                lambda p, b: lfn(p, cfg, b))
    lfn = base._REC_LOSS[arch.arch_id]
    return (base._REC_INIT[arch.arch_id](seed, cfg, device=device),
            lambda p, b: lfn(p, cfg, b))


def to_device_fn(device):
    """A host batch (dict of numpy arrays) as tensors on ``device``."""
    def to_dev(batch):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in batch.items()}
    return to_dev


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None,
                    help="train shape id (default: first train shape)")
    ap.add_argument("--scale", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(argv=None):
    """Parse ``argv``, train, print the run's lines; the loop's result."""
    args = parse(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    from repro_torch import configs
    from repro_torch.train import loop as loop_lib
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.core import tree

    device = torch.device(args.device)
    if device.type == "cuda":
        deterministic()
    arch = configs.get_arch(args.arch)
    shapes = arch.shapes if args.scale == "full" else arch.smoke_shapes
    shape_id = args.shape or next(
        (k for k, v in shapes.items()
         if v.get("step", "train") == "train" or arch.kind == "gnn"),
        list(shapes)[0])
    shp = shapes[shape_id]
    cfg = arch.make_config(args.scale, shape_id)
    params, loss_fn = model_fns(arch, cfg, shp, args.seed, device)

    n_params = sum(int(x.numel()) for x in tree.leaves(params))
    print(f"arch={args.arch} shape={shape_id} scale={args.scale} "
          f"params={n_params:,} device={device}")

    ocfg = opt_lib.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10,
                                                            1),
                               total_steps=args.steps)
    opt_state = opt_lib.init(params)
    step_fn = opt_lib.make_train_step(loss_fn, ocfg, args.microbatches)
    lcfg = loop_lib.LoopConfig(total_steps=args.steps,
                               ckpt_dir=args.ckpt_dir,
                               ckpt_every=args.ckpt_every,
                               log_every=args.log_every)
    res = loop_lib.fit(step_fn, params, opt_state,
                       make_batch_fn(arch, cfg, shp, args.seed), lcfg,
                       to_device=to_device_fn(device))
    print(f"done: step={res.step} loss={float(res.metrics['loss']):.4f} "
          f"stragglers={res.stragglers} retries={res.retries}")
    return res


def main(argv=None) -> int:
    res = run(argv)
    return 0 if math.isfinite(float(res.metrics["loss"])) else 1


if __name__ == "__main__":
    raise SystemExit(main())
