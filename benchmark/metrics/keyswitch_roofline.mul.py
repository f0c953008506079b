"""Share of its roofline that the relinearization's key switch (B7/B12,
the ``keyswitch`` kernels) reaches in the window: each call's least time
for keyswitch(n, k, kd, B) of benchmark/workcounts.py, times the calls,
over the profiler's durations of those kernels."""

from benchmark import trace, workcounts


def read(run):
    ops = trace.matching(run.ops, "keyswitch")
    p = run.params
    least, _ = workcounts.min_seconds(workcounts.keyswitch(p.n, p.k, run.kd, run.batch))
    return trace.roofline_percent(least, run.window.calls, ops)
