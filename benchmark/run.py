"""Run one cell of the benchmark of fhe_tpu_torch on the card, once.

    python3 benchmark/run.py --workload bfv_n32768_k29.mul_offline \\
        --seed 12345 --seconds 10 --trace 0

Sets the cell up (kernel build or load, keys, pools, warm-up), measures for
``--seconds``, judges a sample of the window's outputs against the plain
reference (benchmark/reference.py) and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` a ``breakdown``, and last the ``checks``,
each compared number beside its limit, which also end standard error.  It
exits non-zero, printing no result, without a card or with fewer cards
than the cell asks for.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch

    from benchmark import harness, workcounts

    cell = harness.load_cell(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                     device="cuda", t_start=T_START, chips=chips)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package loaded: {found}", file=sys.stderr)
        return 3
    print(f"card: {harness.card_note()}; integer peak "
          f"{workcounts.PEAKS['int32_ops_per_s']:.6g} op/s, HBM "
          f"{workcounts.PEAKS['hbm_bytes_per_s']:.6g} B/s", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
