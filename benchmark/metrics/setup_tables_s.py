"""Seconds of set-up in host tables: the prime search and the context's
constants on the device (the ``tables.*`` spans of the program's process
record, fhe_tpu_torch.utils.perf.PROCESS)."""

import sys


def read(run):
    record = getattr(sys.modules.get("fhe_tpu_torch.utils.perf"), "PROCESS", None)
    if record is None:
        return None
    spans = [ms for op, ms in record.get_stats().times_ms.items() if op.startswith("tables.")]
    return sum(spans) / 1e3 if spans else None
