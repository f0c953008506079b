#!/usr/bin/env python3
"""Batch (SIMD) Processing Example on the PyTorch port — slot packing and
batched homomorphic ops.

The port's copy of ``examples/batch_processing.py``: pack slot_count values
per ciphertext, slot-wise add and multiply, a 10-ciphertext accumulation
whose every slot must equal 1+2+...+10 = 55, and the batched
encrypt -> multiply -> decrypt pipeline over 4 ciphertext pairs.  Exit 0
iff all checks pass.  Runs on FHE_EXAMPLE_DEVICE (default "cuda") at
FHE_EXAMPLE_POLY_DEGREE (default 4096); the times include the wait for the
card.

    python examples_torch/batch_processing.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

import numpy as np

from fhe_tpu_torch import FHE
from fhe_tpu_torch.utils.perf import synchronize


def main() -> int:
    print("=== FHE Batch Processing (SIMD) Example ===\n")

    degree = int(os.environ.get("FHE_EXAMPLE_POLY_DEGREE", "4096"))
    device = os.environ.get("FHE_EXAMPLE_DEVICE", "cuda")
    fhe = FHE(poly_degree=degree, log_q=120, seed=11, device=device)
    slot_count = fhe.slot_count
    print(f"  Device: {fhe.device}")
    print(f"  Polynomial degree: {fhe.params.n}")
    print(f"  Available slots (SIMD): {slot_count}\n")

    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)

    ok = True

    # -- batch encode/encrypt: 1, 2, ..., slot_count ---------------------
    batch_data = np.arange(1, slot_count + 1, dtype=np.int64)
    print(f"Encoding {slot_count} values into a single plaintext...")
    pt_batch = fhe.encode(batch_data)
    t0 = time.perf_counter()
    ct_batch = fhe.encrypt(pt_batch, pk)
    synchronize(ct_batch)
    enc_ms = (time.perf_counter() - t0) * 1e3
    print(f"  All {slot_count} values packed into one polynomial")
    print(f"  Encryption: {enc_ms:.2f} ms "
          f"({slot_count / enc_ms * 1e3:,.0f} values/sec)\n")

    rt = fhe.decode(fhe.decrypt(ct_batch, sk))[:slot_count].astype(np.int64)
    if not np.array_equal(rt, batch_data):
        print("FAIL: batch round-trip mismatch")
        return 1
    print("OK: batch round-trip exact\n")

    # -- slot-wise add and multiply --------------------------------------
    batch_a = np.arange(slot_count, dtype=np.int64) % 100
    batch_b = (np.arange(slot_count, dtype=np.int64) * 3 + 1) % 50
    ct_a = fhe.encrypt(fhe.encode(batch_a), pk)
    ct_b = fhe.encrypt(fhe.encode(batch_b), pk)

    print("Computing: ct_a + ct_b (adds each slot independently)")
    t0 = time.perf_counter()
    ct_add = fhe.add(ct_a, ct_b)
    synchronize(ct_add)
    add_ms = (time.perf_counter() - t0) * 1e3
    got = fhe.decode(fhe.decrypt(ct_add, sk))[:slot_count].astype(np.int64)
    ok &= np.array_equal(got, (batch_a + batch_b) % fhe.params.t)
    print(f"  {'OK' if ok else 'FAIL'}: slot-wise add "
          f"({slot_count / max(add_ms, 1e-6) * 1e3:,.0f} slot-ops/sec)\n")

    print("Computing: ct_a * ct_b (multiplies each slot independently)")
    t0 = time.perf_counter()
    ct_mul = fhe.multiply(ct_a, ct_b, rlk)
    synchronize(ct_mul)
    mul_ms = (time.perf_counter() - t0) * 1e3
    got = fhe.decode(fhe.decrypt(ct_mul, sk))[:slot_count].astype(np.int64)
    mul_ok = np.array_equal(got, (batch_a * batch_b) % fhe.params.t)
    ok &= mul_ok
    print(f"  {'OK' if mul_ok else 'FAIL'}: slot-wise multiply "
          f"({slot_count / max(mul_ms, 1e-6) * 1e3:,.0f} slot-ops/sec)\n")

    # -- 10-ciphertext accumulation --------------------------------------
    num_cts = 10
    print(f"Encrypting {num_cts} ciphertexts "
          f"({num_cts * slot_count} total values)...")
    cts = [fhe.encrypt(fhe.encode(np.full(slot_count, i + 1, dtype=np.int64)), pk)
           for i in range(num_cts)]
    print(f"Computing sum of all {num_cts} ciphertexts...")
    t0 = time.perf_counter()
    acc = cts[0]
    for ct in cts[1:]:
        acc = fhe.add(acc, ct)
    synchronize(acc)
    sum_ms = (time.perf_counter() - t0) * 1e3
    print(f"  Sum time: {sum_ms:.2f} ms")

    result = fhe.decode(fhe.decrypt(acc, sk))[:slot_count]
    print(f"Sum result (first 10 slots): {list(map(int, result[:10]))}")
    print("  Expected: all slots = 55")
    sum_ok = bool(np.all(result == 55))
    ok &= sum_ok
    print(f"  {'OK: every slot equals 55' if sum_ok else 'FAIL: slot mismatch'}\n")

    # -- ciphertext-level batching (serving throughput) --------------------
    B = 4
    print(f"Batched pipeline over {B} independent ciphertext pairs...")
    pts_x = [fhe.encode(np.full(slot_count, i + 1, dtype=np.int64))
             for i in range(B)]
    pts_y = [fhe.encode(np.full(slot_count, i + 2, dtype=np.int64))
             for i in range(B)]
    xs = fhe.encrypt_batch(pts_x, pk)
    ys = fhe.encrypt_batch(pts_y, pk)
    prods = fhe.multiply_batch(xs, ys, rlk)
    decs = fhe.decrypt_batch(prods, sk)
    batch_ok = all(
        int(fhe.decode(decs[i])[0]) == (i + 1) * (i + 2) for i in range(B))
    ok &= batch_ok
    print(f"  {'OK' if batch_ok else 'FAIL'}: batched encrypt -> multiply "
          f"-> decrypt ({B} pairs, products "
          f"{[int(fhe.decode(d)[0]) for d in decs]})\n")

    print("Summary:")
    print(f"  Slots per ciphertext: {slot_count}")
    print(f"  Encryption throughput: {slot_count / enc_ms * 1e3:,.0f} values/sec")
    print("=== Example Complete ===")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
