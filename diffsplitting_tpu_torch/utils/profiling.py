"""Step time, steps/s, FLOP/s and MFU by the host clock.

Counterpart: diffsplitting_tpu/utils/profiling.py (`StepTimer`,
`peak_flops_per_chip`). The timer reads the host clock around each
iteration, and CUDA returns before the device finishes, so its rate holds
only in steady state, once the host waits on the device each iteration.
Given the FLOPs of a step (utils/flops.py) it reports the achieved FLOP/s,
and given the card's peak (`peak_flops`) the MFU.

`peak_flops` reads a table keyed by `torch.cuda.get_device_name()`: NVIDIA's
H100 SXM data sheet, dense rates without sparsity at the 700 W limit (bf16
989 TFLOP/s, TF32 495, int8 1,979 TOP/s, FP32 outside the tensor cores 67).
The port computes float32 configs with TF32 off (cuDNN and cuBLAS both), so
a float32 model's MFU is against the FP32 figure; the TF32 entry is there
for a reader of the table, not for `peak_flops`. A card the table does not
know raises.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch

# torch.cuda.get_device_name() -> dense peak FLOP/s (OP/s for int8) by
# compute type; source: NVIDIA H100 Tensor Core GPU data sheet, SXM part
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989e12, "tf32": 495e12, "int8": 1979e12,
                              "float32": 67e12},
}
PEAK_KEYS = {torch.bfloat16: "bfloat16", torch.float32: "float32", torch.int8: "int8"}


def peak_flops(dtype=torch.float32, device=None) -> float:
    """The card's dense peak for products in `dtype` (None: float32, outside
    the tensor cores). Raises ValueError on a device the table does not
    know, the CPU included."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"no peak FLOP/s for a {device.type} device")
    name = torch.cuda.get_device_name(device)
    if name not in PEAK_FLOPS:
        raise ValueError(f"no peak FLOP/s for {name!r}; known: {sorted(PEAK_FLOPS)}")
    return PEAK_FLOPS[name][PEAK_KEYS[dtype or torch.float32]]


class StepTimer:
    """Tracks step wall time (EMA) and derives steps/s and, given the FLOPs
    of a step, FLOP/s; given the card's `peak` FLOP/s too, the MFU."""

    def __init__(self, flops_per_step: Optional[float] = None, ema: float = 0.9,
                 peak: Optional[float] = None):
        self.flops_per_step = flops_per_step
        self.ema = ema
        self.peak = peak
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

    @property
    def mfu(self) -> Optional[float]:
        """FLOP/s over the peak: None without a FLOP count or a peak."""
        rate = self.flops_per_sec
        return None if rate is None or not self.peak else rate / self.peak

    def metrics(self) -> dict:
        out = {}
        if self._avg:
            out["step_time_s"] = self._avg
            out["steps_per_sec"] = self.steps_per_sec
            if self.flops_per_sec is not None:
                out["flops_per_sec"] = self.flops_per_sec
            if self.mfu is not None:
                out["mfu"] = self.mfu
        return out
