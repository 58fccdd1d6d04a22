"""Training loop: checkpoint/restart, straggler deadlines, retry; the
port of ``repro.train.loop``.

Fault-tolerance contract (``tests/test_torch_train.py``):
  * data is deterministic-by-step -> a restart resumes from the latest
    checkpoint and replays the exact same batches;
  * a per-step wall-clock deadline flags stragglers (recorded; the step
    is not re-dispatched);
  * transient step failures retry up to ``max_retries`` with the same
    inputs: safe because steps are pure functions of (params, opt_state,
    batch) (``optimizer.make_train_step``).

A step's wall time ends once the device has finished its metrics
(``torch.cuda.synchronize`` on their device: the counterpart of the
reference's ``block_until_ready``).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable

import torch

from repro_torch.train import checkpoint as ckpt_lib

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    keep_last: int = 3
    log_every: int = 10
    step_deadline_s: float = 0.0     # 0 = disabled
    max_retries: int = 2


@dataclasses.dataclass
class LoopResult:
    params: Any
    opt_state: Any
    step: int
    metrics: dict
    stragglers: int = 0
    retries: int = 0


def _block(metrics: dict) -> None:
    """Wait until the device has computed every tensor of ``metrics``."""
    for dev in {x.device for x in metrics.values()
                if isinstance(x, torch.Tensor) and x.is_cuda}:
        torch.cuda.synchronize(dev)


def fit(step_fn: Callable, params, opt_state, make_batch: Callable[[int], Any],
        cfg: LoopConfig, to_device: Callable[[Any], Any] = None) -> LoopResult:
    """Run the loop.  ``step_fn(params, opt_state, batch) ->
    (params, opt_state, metrics)``; ``make_batch(step) -> batch`` must be
    deterministic in ``step``.
    """
    start = 0
    if cfg.ckpt_dir:
        latest = ckpt_lib.latest_step(cfg.ckpt_dir)
        if latest is not None:
            (params, opt_state), _ = ckpt_lib.restore(
                cfg.ckpt_dir, (params, opt_state), step=latest)
            start = latest
            log.info("resumed from step %d", start)

    stragglers = retries = 0
    metrics: dict = {}
    for step in range(start, cfg.total_steps):
        batch = make_batch(step)
        if to_device is not None:
            batch = to_device(batch)
        t0 = time.monotonic()
        for attempt in range(cfg.max_retries + 1):
            try:
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch)
                _block(metrics)
                break
            except Exception as e:            # noqa: BLE001 — retry path
                retries += 1
                log.warning("step %d attempt %d failed: %s", step, attempt,
                            e)
                if attempt == cfg.max_retries:
                    raise
        dt = time.monotonic() - t0
        if cfg.step_deadline_s and dt > cfg.step_deadline_s:
            stragglers += 1
            log.warning("straggler: step %d took %.3fs (deadline %.3fs)",
                        step, dt, cfg.step_deadline_s)
        if cfg.log_every and (step + 1) % cfg.log_every == 0:
            loss = metrics.get("loss")
            log.info("step %d loss=%s (%.3fs)", step + 1,
                     float(loss) if loss is not None else None, dt)
        if cfg.ckpt_dir and (step + 1) % cfg.ckpt_every == 0:
            ckpt_lib.save(cfg.ckpt_dir, step + 1, (params, opt_state),
                          metadata={"loss": float(metrics.get("loss", 0.0))},
                          keep_last=cfg.keep_last)
    if cfg.ckpt_dir and cfg.total_steps > start and \
            cfg.total_steps % cfg.ckpt_every != 0:
        ckpt_lib.save(cfg.ckpt_dir, cfg.total_steps, (params, opt_state),
                      metadata={"loss": float(metrics.get("loss", 0.0))},
                      keep_last=cfg.keep_last)
    return LoopResult(params=params, opt_state=opt_state,
                      step=cfg.total_steps, metrics=metrics,
                      stragglers=stragglers, retries=retries)
