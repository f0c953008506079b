"""Host milliseconds per dot request inside the program's facade: the
FHE.monitor totals of multiply_plain and sum_slots over the window (no
synchronise), over the requests."""


def read(run):
    times, counts = run.monitor.times_ms, run.monitor.counts
    if not (counts.get("multiply_plain") and counts.get("sum_slots") and run.window.calls):
        return None
    return (times["multiply_plain"] + times["sum_slots"]) / run.window.calls
