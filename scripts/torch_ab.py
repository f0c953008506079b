#!/usr/bin/env python3
"""Device and end-to-end times of the port's multiply and decrypt on one
NVIDIA card, for comparing two trees of the port (a parent and a change)
within one run on the card:

    python3 scripts/torch_ab.py [TREE]

TREE (default: the checkout this script lies in) is the root of a checkout
whose fhe_tpu_torch package is imported, and whose kernels are built, for
the run.  Run it once per tree, in the order parent, change, change, parent.
It prints one JSON line: the card's name and power limit, the tree, and at
the headline configuration (n = 8192, log_q = 90, k = 3, kb = 5):
  - device_ms (CUDA events while the card is kept busy, so host work is
    excluded; median of 25) and wall_ms (CUDA events around the call, host
    work included; median of 10) of multiply_no_relin, relinearize,
    multiply, the decrypt of the product, and decrypt_batch and
    multiply_batch at B = 8, with the batch ops also per ciphertext;
  - the device times of bsk_branch_fused (single, and batched at B = 8) and
    decrypt_fused (on views of a [3, 2, n] ciphertext, and at B = 8) on
    random residues.
The timing methods are those of chip_smoke.py (device_ms, wall_ms).  Imports
no JAX and nothing of fhe_tpu.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

TREE = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parent.parent)
sys.path.insert(0, str(TREE.resolve()))

from fhe_tpu_torch import FHE  # noqa: E402
from fhe_tpu_torch.ops import decrypt_cuda, rns_cuda  # noqa: E402
from fhe_tpu_torch.ops import rns  # noqa: E402

N, LOG_Q, H, BATCH = 8192, 90, 64, 8


def device_ms(fn, reps: int = 25) -> float:
    """Median device time of fn() in ms, the card kept busy
    (torch.cuda._sleep) while the host queues the call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(max(2 * host_s, 50e-6) * 2.0e9)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(fn, reps: int = 10) -> float:
    """Median time of fn() in ms as a caller sees it, host work included."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def residues(gen: torch.Generator, moduli, rows: int) -> torch.Tensor:
    return torch.stack([torch.randint(0, int(p), (rows, N), generator=gen, device="cuda",
                                      dtype=torch.int64) for p in moduli]).to(torch.int32)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    fhe = FHE(poly_degree=N, log_q=LOG_Q, hamming_weight=H, seed=3, device="cuda")
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    cts_a = fhe.encrypt_batch([fhe.encode([5 + i, 10, 15, 20]) for i in range(BATCH)], pk)
    cts_b = fhe.encrypt_batch([fhe.encode([3, 6, 9, 12 + i]) for i in range(BATCH)], pk)
    a, b = cts_a[0], cts_b[0]
    m3 = fhe.multiply_no_relin(a, b)
    prod = fhe.multiply(a, b, rlk)
    got = [int(v) for v in fhe.decode(fhe.decrypt(prod, sk))[:4]]
    if got != [15, 60, 135, 240]:
        raise RuntimeError(f"multiply decoded {got}")
    ops = {"multiply_no_relin": lambda: fhe.multiply_no_relin(a, b),
           "relinearize": lambda: fhe.relinearize(m3, rlk),
           "multiply": lambda: fhe.multiply(a, b, rlk),
           "decrypt_after_multiply": lambda: fhe.decrypt(prod, sk),
           "decrypt_batch_B8": lambda: fhe.decrypt_batch(cts_a, sk),
           "multiply_batch_B8": lambda: fhe.multiply_batch(cts_a, cts_b, rlk)}
    out = {"card": card, "tree": str(TREE), "device_ms": {}, "wall_ms": {}}
    for name, fn in ops.items():
        out["device_ms"][name] = device_ms(fn)
        out["wall_ms"][name] = wall_ms(fn)
    for what in ("device_ms", "wall_ms"):
        for name in ("decrypt_batch_B8", "multiply_batch_B8"):
            out[what][name + "_per_ct"] = out[what][name] / BATCH
    ctx = fhe.ctx
    gen = torch.Generator(device="cuda").manual_seed(7)
    qs, tbsk = ctx.ntt_q.primes, ctx.mul_tables[1]
    ab, tx_q = residues(gen, qs, 4), residues(gen, qs, 3)
    ab_b = residues(gen, qs, 4 * BATCH).view(3, BATCH, 4, N).transpose(0, 1)
    ab_b = ab_b.contiguous().permute(1, 2, 0, 3)
    tx_b = residues(gen, qs, 3 * BATCH).view(3, 3, BATCH, N)
    ct = residues(gen, qs, 2)
    s = residues(gen, qs, 1)
    c0, c1 = residues(gen, qs, BATCH), residues(gen, qs, BATCH)
    dc = rns.make_decrypt(qs, fhe.params.t, fhe.params.gamma, "cuda")
    kernels = {
        "bsk_branch_fused": lambda: rns_cuda.bsk_branch_fused(
            ab, tx_q, ctx.smq, ctx.floor_c, tbsk),
        "bsk_branch_fused_batch_B8": lambda: rns_cuda.bsk_branch_fused_batch(
            ab_b, tx_b, ctx.smq, ctx.floor_c, tbsk),
        "decrypt_fused": lambda: decrypt_cuda.decrypt_fused(
            ct[:, 0:1], ct[:, 1:2], s, ctx.ntt_q, dc),
        "decrypt_fused_B8": lambda: decrypt_cuda.decrypt_fused(c0, c1, s, ctx.ntt_q, dc)}
    out["kernel_device_ms"] = {name: device_ms(fn) for name, fn in kernels.items()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
