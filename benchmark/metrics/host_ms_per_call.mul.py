"""Host milliseconds per multiply_batch call over the window: the facade's
own timer (FHE.monitor, no synchronise), total over count."""


def read(run):
    count = run.monitor.counts.get("multiply_batch", 0)
    return run.monitor.times_ms["multiply_batch"] / count if count else None
