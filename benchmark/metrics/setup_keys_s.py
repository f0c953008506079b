"""Seconds of set-up in key material: the key pair, relinearization and
Galois keys, and the pre-permuted hoisted key stacks, each to the card's
end of the work (the ``keys.*`` spans of the program's process record,
fhe_tpu_torch.utils.perf.PROCESS)."""

import sys


def read(run):
    record = getattr(sys.modules.get("fhe_tpu_torch.utils.perf"), "PROCESS", None)
    if record is None:
        return None
    spans = [ms for op, ms in record.get_stats().times_ms.items() if op.startswith("keys.")]
    return sum(spans) / 1e3 if spans else None
