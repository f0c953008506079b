"""Seconds of set-up in loading the CUDA kernels, with their build where
nvcc ran (the ``kernels.load`` span of the program's process record,
fhe_tpu_torch.utils.perf.PROCESS)."""

import sys


def read(run):
    record = getattr(sys.modules.get("fhe_tpu_torch.utils.perf"), "PROCESS", None)
    if record is None:
        return None
    ms = record.get_stats().times_ms.get("kernels.load")
    return None if ms is None else ms / 1e3
