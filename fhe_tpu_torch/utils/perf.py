"""Performance monitoring — counterpart of ``fhe_tpu/utils/perf.py``: the
``PerfStats`` / ``PerformanceMonitor`` the FHE facade times its ops with,
the scheme layer's ``span``, and ``PROCESS``, the record of one-time work.

Times are wall-clock milliseconds on the host.  Kernel launches return
before the card finishes, so a caller who wants the device work inside the
time passes ``sync=`` (a tensor, or a ciphertext, key or list holding
tensors): the monitor then waits for the card of every CUDA tensor found
before it stops the clock.

While a ``torch.profiler`` session records, every timed op and every
``span`` also opens ``record_function("fhe." + name)``, which the profiler
puts on the timeline of the card's kernels.  With no session recording, a
span costs one flag check and returns a shared no-op context.

``reset`` also snapshots the CUDA caching allocator's counters, where CUDA
is initialised, and ``get_stats`` reports the bytes and blocks allocated
since: every tensor the program made on the card, kernel outputs and torch
glue alike.

``PROCESS`` records one-time work, and nothing resets it: the prime search
and the context's tables (``tables.primes``, ``tables.context``), the CUDA
context (``device.start``), the kernels' load (``kernels.load``, with
``kernels.build`` inside it when ``nvcc`` ran) and key material
(``keys.keygen``, ``keys.relin``, ``keys.galois``, ``keys.hoisted``; each
span ends when the card has finished the keys).  No two of its span
families nest.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict

import torch
from torch.autograd import profiler as _autograd_profiler

from .debug import tensor_leaves

# the CUDA caching allocator's running totals of bytes and blocks handed out
_ALLOC_KEYS = ("allocated_bytes.all.allocated", "allocation.all.allocated")
_NO_SPAN = contextlib.nullcontext()


@dataclasses.dataclass
class PerfStats:
    """Aggregate op statistics: total milliseconds and call counts per op,
    and the bytes and blocks the CUDA allocator handed out since the
    monitor's reset (None where CUDA was not initialised at the reset)."""

    times_ms: dict[str, float]
    counts: dict[str, int]
    alloc_bytes: int | None = None
    allocs: int | None = None

    def mean_ms(self, op: str) -> float:
        c = self.counts.get(op, 0)
        return self.times_ms.get(op, 0.0) / c if c else 0.0


def span(name: str):
    """A profiler range ``fhe.<name>`` while a torch profiler records, else
    a shared no-op context."""
    if _autograd_profiler._is_profiler_enabled:
        return _autograd_profiler.record_function("fhe." + name)
    return _NO_SPAN


def synchronize(obj) -> None:
    """Wait until the card has finished the work queued for the tensors in
    obj (a tensor, a dataclass such as a Ciphertext, or a list, tuple or
    dict of those)."""
    for dev in {t.device for t in tensor_leaves(obj) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def _alloc_counters() -> tuple[int, ...] | None:
    if not torch.cuda.is_initialized():
        return None
    stats = torch.cuda.memory_stats()
    return tuple(stats.get(k, 0) for k in _ALLOC_KEYS)


class PerformanceMonitor:
    """Host time and calls per op name, timed by a context manager around
    each call, and the allocator's counts since the last reset."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._total_ms = defaultdict(float)
        self._counts = defaultdict(int)
        self._alloc0 = _alloc_counters()

    @contextlib.contextmanager
    def time(self, op: str, sync=None):
        """Time the body as one call of ``op`` (a span ``fhe.<op>`` while a
        profiler records); with ``sync``, wait for the card of its tensors
        before stopping the clock."""
        with span(op):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if sync is not None:
                    synchronize(sync)
                self._total_ms[op] += (time.perf_counter() - t0) * 1e3
                self._counts[op] += 1

    def get_stats(self) -> PerfStats:
        now = _alloc_counters() if self._alloc0 is not None else None
        alloc = (None, None) if now is None else tuple(b - a for a, b in zip(self._alloc0, now))
        return PerfStats(times_ms=dict(self._total_ms), counts=dict(self._counts),
                         alloc_bytes=alloc[0], allocs=alloc[1])

    def print_stats(self):
        stats = self.get_stats()
        for op in sorted(stats.counts):
            print(f"  {op:20s} {stats.counts[op]:6d} calls  "
                  f"{stats.mean_ms(op):10.3f} ms/call  "
                  f"{stats.times_ms.get(op, 0.0):10.1f} ms total")
        if stats.alloc_bytes is not None:
            print(f"  allocated {stats.alloc_bytes / 1e6:.1f} MB in {stats.allocs} blocks")


# one-time work of this process (module docstring); never reset
PROCESS = PerformanceMonitor()
