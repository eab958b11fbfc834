"""Step time and steps/s by the host clock.

Counterpart: diffsplitting_tpu/utils/profiling.py `StepTimer`. The timer
reads the host clock around each iteration, and CUDA returns before the
device finishes, so its rate holds only in steady state, once the host waits
on the device each iteration. Given the FLOPs of a step it also reports the
achieved FLOP/s; MFU against the H100's peak waits for a FLOP count of the
UNet (ROADMAP §1 item 1g), and until then split.py passes
`flops_per_step=None`.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional


class StepTimer:
    """Tracks step wall time (EMA) and derives steps/s and, given the FLOPs
    of a step, FLOP/s."""

    def __init__(self, flops_per_step: Optional[float] = None, ema: float = 0.9):
        self.flops_per_step = flops_per_step
        self.ema = ema
        self._avg = None
        self._last = None

    def start(self):
        self._last = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._last
        self._avg = dt if self._avg is None else self.ema * self._avg + (1 - self.ema) * dt
        return dt

    @contextlib.contextmanager
    def step(self):
        self.start()
        try:
            yield
        finally:
            self.stop()

    @property
    def avg_step_time(self) -> Optional[float]:
        return self._avg

    @property
    def steps_per_sec(self) -> Optional[float]:
        return None if not self._avg else 1.0 / self._avg

    @property
    def flops_per_sec(self) -> Optional[float]:
        if not self._avg or not self.flops_per_step:
            return None
        return self.flops_per_step / self._avg

    def metrics(self) -> dict:
        out = {}
        if self._avg:
            out["step_time_s"] = self._avg
            out["steps_per_sec"] = self.steps_per_sec
            if self.flops_per_sec is not None:
                out["flops_per_sec"] = self.flops_per_sec
        return out
