"""Set-up's phases on the host clock, each from the end of the last."""
from __future__ import annotations

import time


class Laps:
    def __init__(self):
        self.t = time.perf_counter()
        self.phases: dict[str, float] = {}

    def __call__(self, name: str) -> None:
        t = time.perf_counter()
        self.phases[name] = self.phases.get(name, 0.0) + (t - self.t)
        self.t = t
