"""AdamW + schedules + gradient clipping: the port of
``repro.train.optimizer`` (no ``torch.optim``).

The state mirrors the params (m, v) beside a scalar step.  The train
step is pure, as the reference's jitted step is: it returns new tensors
and leaves its inputs' bits untouched (each param enters autograd as a
fresh leaf through ``detach``), so ``train.loop`` may retry a failed
step on the same inputs.  Trees flatten in JAX's leaf order
(``core.tree``).

Differences from the reference, by design:
  * the step is not compiled: ``make_train_step`` returns a plain
    function, and the gradients come from autograd of the port's loss;
  * the arithmetic is the reference's, op for op in f32, but XLA on the
    CPU contracts some products into FMAs and has its own ``cos``,
    ``pow`` and reduction order: ``update`` agrees with the reference's
    within a few ulp, not to the bit (``tests/test_torch_train.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from repro_torch.core import tree

Tensor = torch.Tensor


class AdamWState(NamedTuple):
    step: Tensor       # i32 scalar
    m: dict            # first moment  (mirrors params)
    v: dict            # second moment (mirrors params)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"      # "cosine" | "linear" | "constant"


def lr_at(cfg: AdamWConfig, step: Tensor) -> Tensor:
    """The learning rate at ``step`` (an integer tensor): linear warmup,
    then the schedule's decay, an f32 scalar on the step's device."""
    s = step.float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((s - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * \
            0.5 * (1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1.0 - cfg.min_lr_ratio) * frac
    else:
        decay = torch.ones_like(s)
    return cfg.lr * warm * decay


def init(params) -> AdamWState:
    """Zero moments beside each param, and step 0 on the params' device."""
    flat = tree.leaves(params)
    dev = flat[0].device if flat else "cpu"
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree.map(torch.zeros_like, params),
                      v=tree.map(torch.zeros_like, params))


def global_norm(grads) -> Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares."""
    sq = [torch.sum(torch.square(x.float())) for x in tree.leaves(grads)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def update(cfg: AdamWConfig, grads, state: AdamWState, params):
    """One AdamW step.  Returns (new_params, new_state, metrics); the
    inputs are not modified."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0) if cfg.clip_norm > 0 else \
        torch.ones_like(gnorm)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1c = 1.0 - torch.pow(torch.full_like(lr, cfg.b1), step.float())
    b2c = 1.0 - torch.pow(torch.full_like(lr, cfg.b2), step.float())

    def upd(p, g, m, v):
        g = g.float() * scale
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m2 / b1c
        vhat = v2 / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * \
            p.float()
        return (p.float() - lr * delta).to(p.dtype), m2, v2

    flat_p, td = tree.flatten(params)
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        flat_p, tree.leaves(grads), tree.leaves(state.m),
        tree.leaves(state.v))]
    new_p = tree.unflatten(td, [o[0] for o in out])
    new_m = tree.unflatten(td, [o[1] for o in out])
    new_v = tree.unflatten(td, [o[2] for o in out])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, AdamWState(step=step, m=new_m, v=new_v), metrics


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)`` by autograd: each param
    enters as a fresh leaf (``detach``), so nothing of ``params`` is
    written, and the grads mirror the params' tree and dtypes."""
    flat, td = tree.flatten(params)
    leaves = [p.detach().requires_grad_() for p in flat]
    with torch.enable_grad():
        loss = loss_fn(tree.unflatten(td, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return loss.detach(), tree.unflatten(td, grads)


def make_train_step(loss_fn: Callable, cfg: AdamWConfig,
                    microbatches: int = 1) -> Callable:
    """Build a full train step: (params, opt_state, batch) ->
    (params, opt_state, metrics), ``metrics["loss"]`` the batch's loss.

    ``microbatches`` > 1 accumulates gradients over leading-dim splits of
    the batch in f32 (gradient accumulation: less peak activation
    memory), then divides loss and gradients by their count.
    """
    def step(params, opt_state, batch):
        if microbatches <= 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            def split(x, i):
                b = x.shape[0] // microbatches
                return x.reshape((microbatches, b) + tuple(x.shape[1:]))[i]

            loss = None
            grads = tree.map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(microbatches):
                loss_i, grads_i = value_and_grad(
                    loss_fn, params, tree.map(lambda x: split(x, i), batch))
                grads = tree.map(torch.add, grads, grads_i)
                loss = loss_i.float() if loss is None else loss + loss_i
            loss = loss / microbatches
            grads = tree.map(lambda g: g / microbatches, grads)
        new_params, new_state, metrics = update(cfg, grads, opt_state,
                                                params)
        metrics["loss"] = loss
        return new_params, new_state, metrics

    return step
