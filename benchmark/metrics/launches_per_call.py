"""Kernel launches per call of the window (a multiply_batch call, or a dot
request: multiply_plain, then sum_slots): the kernel wrappers' launch
counters (every lane), taken just before and after the window."""


def read(run):
    total = sum(run.launches.values())
    return total / run.window.calls if total and run.window.calls else None
