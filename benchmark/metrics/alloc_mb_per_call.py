"""Megabytes (1e6 bytes) that the CUDA caching allocator handed out per
call of the window (a multiply_batch call, or a dot request): FHE.monitor's
allocator count from its reset just before the window to just after it,
every tensor the program made, kernel outputs and torch glue alike."""


def read(run):
    got = getattr(run.monitor, "alloc_bytes", None)
    return got / 1e6 / run.window.calls if got is not None and run.window.calls else None
