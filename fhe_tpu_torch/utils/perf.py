"""Performance monitoring — counterpart of ``fhe_tpu/utils/perf.py``: the
``PerfStats`` / ``PerformanceMonitor`` the FHE facade times its ops with.

Times are wall-clock milliseconds on the host.  Kernel launches return
before the card finishes, so a caller who wants the device work inside the
time passes ``sync=`` (a tensor, or a ciphertext, key or list holding
tensors): the monitor then waits for the card of every CUDA tensor found
before it stops the clock.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict

import torch

from .debug import tensor_leaves


@dataclasses.dataclass
class PerfStats:
    """Aggregate op statistics: total milliseconds and call counts per op."""

    times_ms: dict[str, float]
    counts: dict[str, int]

    def mean_ms(self, op: str) -> float:
        c = self.counts.get(op, 0)
        return self.times_ms.get(op, 0.0) / c if c else 0.0


def synchronize(obj) -> None:
    """Wait until the card has finished the work queued for the tensors in
    obj (a tensor, a dataclass such as a Ciphertext, or a list, tuple or
    dict of those)."""
    for dev in {t.device for t in tensor_leaves(obj) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


class PerformanceMonitor:
    """A start/stop timer per op name, and a context manager around a call."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._total_ms = defaultdict(float)
        self._counts = defaultdict(int)
        self._open = {}

    def start_timer(self, op: str):
        self._open[op] = time.perf_counter()

    def stop_timer(self, op: str):
        t0 = self._open.pop(op, None)
        if t0 is None:
            return
        self._total_ms[op] += (time.perf_counter() - t0) * 1e3
        self._counts[op] += 1

    def record_operation(self, op: str):
        self._counts[op] += 1

    @contextlib.contextmanager
    def time(self, op: str, sync=None):
        """Time the body as one call of ``op``; with ``sync``, wait for the
        card of its tensors before stopping the clock."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                synchronize(sync)
            self._total_ms[op] += (time.perf_counter() - t0) * 1e3
            self._counts[op] += 1

    def get_stats(self) -> PerfStats:
        return PerfStats(times_ms=dict(self._total_ms), counts=dict(self._counts))

    def print_stats(self):
        stats = self.get_stats()
        for op in sorted(stats.counts):
            print(f"  {op:20s} {stats.counts[op]:6d} calls  "
                  f"{stats.mean_ms(op):10.3f} ms/call  "
                  f"{stats.times_ms.get(op, 0.0):10.1f} ms total")
