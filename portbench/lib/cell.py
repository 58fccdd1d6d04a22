"""One run of one cell: set-up, the measured window, the readings, and
the check of every answer against the reference.

The set-up builds the deployment from the seed (the configuration's
deployment), makes the traffic (the mix's load) and warms every shape the
traffic uses.  The window runs ``seconds`` of traffic; with ``trace`` it
runs under the profiler, and the per-layer readers read it.  Then the
peak device memory is read, the program's state is freed, and the
reference judges every answer.
"""
from __future__ import annotations

import dataclasses
import math
import sys
import threading
import time

import numpy as np

from portbench.lib import manifest as mf
from portbench.lib import profiling, readers

BANNED = ("jax", "jaxlib", "flax", "repro")


class NoDevice(RuntimeError):
    pass


@dataclasses.dataclass
class Context:
    session: object
    system: object
    events: object
    t0: float
    t1: float
    scoring_tids: set


def merged(base: dict, over: dict | None) -> dict:
    """``base`` with ``over``'s keys put in, nested dicts key by key."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def banned_modules(names=None) -> list:
    """Loaded modules (``names``, by default ``sys.modules``) whose
    top-level name, compared whole, is JAX's or its package's."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".")[0] for n in names
                   if n.split(".")[0] in BANNED})


def device_of(chips: int):
    import torch
    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: the benchmark measures the card")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} cards, "
                       f"{torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def run(name: str, seed: int, seconds: float, trace: bool, device,
        t_process: float, control: bool = False,
        config_over: dict | None = None, mix_over: dict | None = None):
    """One run: (its result line, the numbers compared for the program
    and, with ``control``, for the control).  ``config_over`` and
    ``mix_over`` replace keys of the configuration and the mix (the
    tests' tiny cells)."""
    import torch
    m = mf.load()
    cell = mf.workload(m, name)
    cfg = merged(mf.config(m, cell["config"]), config_over)
    mix = merged(mf.traffic(cell["traffic"]), mix_over)
    device = torch.device(device)
    cuda = device.type == "cuda"
    deployment = mf.module("deployments", cfg["deployment"])
    load = mf.module("loads", mix["load"])

    t_build = time.perf_counter()
    system = deployment.build(cfg, seed, device, trace)
    t_traffic = time.perf_counter()
    session = load.Session(system, mix, seed, seconds)
    t_warm = time.perf_counter()
    session.warm()
    if cuda:
        torch.cuda.synchronize()
    with profiling.DeviceTrace(enabled=trace and cuda) as dt:
        session.window()
    setup_s = session.t_start - t_process
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    values = dict(session.e2e(), setup_s=setup_s, peak_mem_gb=peak / 1e9)
    phases = {"start": t_build - t_process, **system.phases,
              "traffic": t_warm - t_traffic,
              "warm": session.t_start - t_warm}
    print("set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()),
          file=sys.stderr)
    if hasattr(session, "notes"):
        print(session.notes(), file=sys.stderr)
    metrics = {}
    section = "per_layer" if trace else "end_to_end"
    ctx = Context(session, system, dt.events, session.t_start,
                  session.t_end, getattr(session, "server_tids", None)
                  or profiling.thread_ids(threading.current_thread()))
    for spec in mf.metrics_of(m, section, name):
        if trace:
            v = mf.module("metrics", spec["name"]).read(ctx)
        else:
            v = values[spec["name"]]
        if v is not None and math.isfinite(v):
            metrics[spec["name"]] = {"value": float(v), "unit": spec["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    line = {"attempted": session.attempted(), "failed": session.failed(),
            "metrics": metrics, "device": dev}
    if trace and dt.events is not None:
        ev = dt.events
        dev["busy_s"] = ev.busy_s(ctx.t0, ctx.t1)
        dev["window_s"] = ctx.t1 - ctx.t0
        line["breakdown"] = {
            "device_ops": profiling.top(ev.by_name(readers.in_window(ctx))),
            "idle_gaps": readers.label_gaps(ctx)}
        tids, counts = np.unique(ev.tid, return_counts=True)
        print(f"trace: {len(ev.names)} device activities by launching "
              f"thread {dict(zip(tids.tolist(), counts.tolist()))}; "
              f"scoring threads {sorted(ctx.scoring_tids)}",
              file=sys.stderr)
    del ctx
    system.release()

    numbers = session.check(device, control=control)
    limits = cfg["check_limits"]
    checks = {k: {"value": numbers["program"][k], "limit": limits[k]}
              for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    line = {"correct": correct, **line, "checks": checks}
    return line, numbers


def check_lines(checks: dict) -> list:
    return [f"check {k}: {c['value']!r} (limit {c['limit']!r})"
            for k, c in checks.items()]
