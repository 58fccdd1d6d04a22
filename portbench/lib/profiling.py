"""The device trace of a window: ``torch.profiler`` (CUPTI) activity of
the card, read into plain arrays on the host clock.

Each device activity (kernel, copy, set) has a name, a start and an end
on ``time.perf_counter``'s clock (the trace's epoch timestamps shifted by
the offset between the wall clock and ``perf_counter``, read when the
trace starts), and the native id of the host thread that launched it
(from the CUDA runtime call its correlation id names; -1 where the trace
has none).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class DeviceEvents:
    names: list
    start: np.ndarray      # s, perf_counter clock
    end: np.ndarray
    tid: np.ndarray        # launching thread's native id, -1 unknown

    def busy_s(self, t0: float, t1: float, mask=None) -> float:
        """Seconds of [t0, t1] in which at least one activity ran."""
        iv = self.intervals(t0, t1, mask)
        return float((iv[:, 1] - iv[:, 0]).sum())

    def intervals(self, t0: float, t1: float, mask=None) -> np.ndarray:
        """The union of the activities' spans, clipped to [t0, t1], as
        sorted disjoint rows (start, end)."""
        s = np.clip(self.start, t0, t1)
        e = np.clip(self.end, t0, t1)
        if mask is not None:
            s, e = s[mask], e[mask]
        keep = e > s
        return merge(s[keep], e[keep])

    def gaps(self, t0: float, t1: float) -> np.ndarray:
        """Idle stretches (start, end) of [t0, t1]: no activity ran."""
        iv = self.intervals(t0, t1)
        starts = np.concatenate([[t0], iv[:, 1]])
        ends = np.concatenate([iv[:, 0], [t1]])
        keep = ends > starts
        return np.stack([starts[keep], ends[keep]], axis=1)

    def by_name(self, mask=None) -> dict:
        """Seconds of device time by activity name."""
        dur = self.end - self.start
        out: dict = {}
        for i, name in enumerate(self.names):
            if mask is None or mask[i]:
                out[name] = out.get(name, 0.0) + float(dur[i])
        return out


def merge(start: np.ndarray, end: np.ndarray) -> np.ndarray:
    """The union of intervals [start, end) as sorted disjoint rows."""
    if len(start) == 0:
        return np.zeros((0, 2))
    order = np.argsort(start, kind="stable")
    s, e = start[order], end[order]
    reach = np.maximum.accumulate(e)
    new = np.concatenate([[True], s[1:] > reach[:-1]])
    at = np.flatnonzero(new)
    return np.stack([s[at], np.maximum.reduceat(e, at)], axis=1)


def covers(iv: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Whether each time ``t`` lies inside one of the rows of ``iv``."""
    if len(iv) == 0:
        return np.zeros(len(t), bool)
    i = np.searchsorted(iv[:, 0], t, side="right") - 1
    return (i >= 0) & (t < iv[np.maximum(i, 0), 1])


class DeviceTrace:
    """Context manager: traces the card's activity while open; ``events``
    holds what it saw once closed.  ``enabled=False`` traces nothing."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.events: DeviceEvents | None = None
        self._prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._offset_ns = time.time_ns() - time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        import torch
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        self.events = read(self._prof, self._offset_ns)
        self._prof = None
        return False


def read(prof, offset_ns: int) -> DeviceEvents:
    """The device activities of a finished profiler ``prof``; its epoch
    timestamps lie ``offset_ns`` after ``perf_counter_ns``'s."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    launcher = {}
    device = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            device.append(e)
        elif e.name().startswith("cuda"):
            # a CUDA runtime call: its resource id is the host thread's
            launcher[e.correlation_id()] = e.device_resource_id()
    start = np.array([e.start_ns() - offset_ns for e in device],
                     np.float64) / 1e9
    dur = np.array([e.duration_ns() for e in device], np.float64) / 1e9
    tid = np.array([launcher.get(e.correlation_id(), -1) for e in device],
                   np.int64)
    return DeviceEvents(names=[e.name() for e in device],
                        start=start, end=start + dur,
                        tid=tid)


def thread_ids(thread) -> set:
    """The ids a trace may name ``thread`` by: its native id, and its
    pthread handle (``ident``) whole and cut to a signed 32-bit value."""
    ident = thread.ident or 0
    low = ((ident & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
    return {thread.native_id, ident, low}


def short(name: str, width: int = 96) -> str:
    """A device activity's name without its argument list, at most
    ``width`` characters."""
    if not name.startswith("Mem"):
        name = name.replace("(anonymous namespace)", "(anon)")
        head, sep, _ = name.rpartition(">(")
        name = head + ">" if sep else name.split("(", 1)[0]
    return name[:width]


def top(seconds: dict, n: int = 10) -> list:
    """The ``n`` largest ``[name, seconds]`` entries."""
    merged: dict = {}
    for name, s in seconds.items():
        merged[short(name)] = merged.get(short(name), 0.0) + s
    return [[k, v] for k, v in sorted(merged.items(),
                                      key=lambda kv: -kv[1])[:n]]
