"""Reduction of a traced window to the numbers the per-layer readers and
the result's ``breakdown`` report.

Device operations are (start_us, end_us, name) triples from the profiler;
host operations (start_us, end_us, name) of the thread that drove the
window.  The arithmetic is that of a call's trace span: the time inside
device operations over the span from the first one's start to the last
one's end, applied to the whole window.
"""

from __future__ import annotations

import collections


def merged(ops) -> list[tuple[float, float]]:
    """The union of the operations' intervals, as sorted disjoint
    (start, end) pairs."""
    out: list[list[float]] = []
    for start, end, *_ in sorted(ops):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(s, e) for s, e in out]


def busy_us(ops) -> float:
    """Microseconds in which at least one operation ran."""
    return sum(e - s for s, e in merged(ops))


def idle_share(ops) -> float | None:
    """1 - busy / span, over the span from the first operation's start to
    the last one's end; None without operations."""
    spans = merged(ops)
    if not spans:
        return None
    span = spans[-1][1] - spans[0][0]
    return 1 - sum(e - s for s, e in spans) / span if span > 0 else None


def matching(ops, part: str) -> list:
    """The operations whose name contains ``part``."""
    return [op for op in ops if part in op[2]]


def total_seconds(ops) -> float:
    return sum(e - s for s, e, *_ in ops) * 1e-6


def top_ops(ops, count: int = 10) -> list:
    """[name, seconds] of the ``count`` names with the most device time."""
    totals = collections.Counter()
    for start, end, name in ops:
        totals[name] += (end - start) * 1e-6
    return [[name, secs] for name, secs in totals.most_common(count)]


def idle_gaps(ops, host, count: int = 10) -> list:
    """[what the host was doing, seconds] for the ``count`` host operations
    that the card waited on longest: each gap between busy spans is put to
    the innermost host operation open when the gap began (host operations
    of one thread nest), and the gaps of one name are summed."""
    spans = merged(ops)
    gaps = [(a[1], b[0]) for a, b in zip(spans, spans[1:]) if b[0] > a[1]]
    events = sorted(host)
    totals = collections.Counter()
    stack: list[tuple] = []
    i = 0
    for g0, g1 in gaps:
        while i < len(events) and events[i][0] <= g0:
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] < g0:
            stack.pop()
        name = stack[-1][2] if stack else "(host between operations)"
        totals[name] += (g1 - g0) * 1e-6
    return [[name, secs] for name, secs in totals.most_common(count)]


def roofline_percent(least_s_each: float, count: int, ops) -> float | None:
    """Share of the least time ``count`` units of work could take, each
    ``least_s_each`` seconds, in the measured time of ``ops``; None where
    nothing ran."""
    spent = total_seconds(ops)
    if not ops or count == 0 or spent <= 0:
        return None
    return 100 * least_s_each * count / spent
