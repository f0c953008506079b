"""Share of its roofline that the hoisted key switch of sum_slots (B17,
the ``ks_inner`` kernels) reaches in the window: the least time of each
radix-4 stage's ks_inner(n, k, kd, E) of benchmark/workcounts.py, summed
over a request's stages, times the requests, over the profiler's
durations of those kernels.  A stage hoists the rotations {s, 2s, 3s}
that stay inside a slot row (E of them), as FHE.sum_slots does with the
keys of sum_slots_elements()."""

from benchmark import trace, workcounts


def stage_elements(n: int) -> list[int]:
    half, step, out = n // 2, 1, []
    while step < half:
        group = [j * step for j in (1, 2, 3) if j * step < half]
        if len(group) > 1:
            out.append(len(group))
            step *= len(group) + 1
        else:
            step *= 2
    return out


def read(run):
    ops = trace.matching(run.ops, "ks_inner")
    p = run.params
    least = sum(workcounts.min_seconds(workcounts.ks_inner(p.n, p.k, run.kd, e))[0]
                for e in stage_elements(p.n))
    return trace.roofline_percent(least, run.window.calls, ops)
