"""The readings a cell's limits are set from: the compared numbers of many
seeds, read in one process (the kernels built and loaded once), with a
short window at the cell's own load.

    python3 benchmark/readings.py --workload bfv_n32768_k29.mul_offline \\
        --seeds 101 102 103 --seconds 3 [--control]

``--control`` runs the program's own coarser key switch, two q primes a
gadget digit (``ks_omega = 2``) where the configuration states one: the
step below the stated precision that a later change would be tempted by.
One JSON line per seed: the seed, each check's value, the end-to-end
metrics.  The benchmark's own runs never run this.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args()

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if args.control:
        cell.config["security"]["ks_omega"] = 2
    for seed in args.seeds:
        result, _ = harness.run_cell(cell, seed, args.seconds, False)
        print(json.dumps({"workload": args.workload, "control": args.control, "seed": seed,
                          "checks": {k: v["value"] for k, v in result["checks"].items()},
                          "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                          "attempted": result["attempted"],
                          "memory_peak_bytes": result["device"]["memory_peak_bytes"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
