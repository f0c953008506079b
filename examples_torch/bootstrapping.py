#!/usr/bin/env python3
"""Bootstrapping Example on the PyTorch port — extract_lsb -> blind_rotate
-> modulus_raise -> key_switch on an encrypted bit.

The port's copy of ``examples/bootstrapping.py``: a noisy ciphertext is
refreshed without decrypting (an LWE sample and a CGGI accumulator
rotation of 2n RGSW external products), for both bit values, then a
programmable bootstrap evaluates m -> m^2 mod 5 on a 2-bit payload.  The
same parameters and seed; exit 0 iff every refresh decrypts as expected.
Runs on FHE_EXAMPLE_DEVICE (default "cuda") at FHE_EXAMPLE_POLY_DEGREE
(default 256: the rotation costs 2n external products).

    python examples_torch/bootstrapping.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch

from fhe_tpu_torch import FHE
from fhe_tpu_torch.scheme.types import Plaintext


def main() -> int:
    print("=== FHE Bootstrapping Example ===\n")

    degree = int(os.environ.get("FHE_EXAMPLE_POLY_DEGREE", "256"))
    device = os.environ.get("FHE_EXAMPLE_DEVICE", "cuda")
    fhe = FHE(lambda_=0, poly_degree=degree, log_q=120, hamming_weight=16,
              seed=7, device=device)
    print(f"1. Parameters: n={fhe.params.n}, k={fhe.params.k} RNS primes, "
          f"device {fhe.device}\n")

    print("2. Generating keys (incl. the RGSW bootstrap key)...")
    pk, sk = fhe.keygen()
    bsk = fhe.make_bootstrap_key(sk)
    print("   done\n")

    def coeff_plaintext(m: int) -> Plaintext:
        data = torch.zeros(fhe.params.n, dtype=torch.int32, device=fhe.device)
        data[0] = m
        return Plaintext(data=data)

    ok = True
    for bit in (0, 1):
        ct = fhe.encrypt(coeff_plaintext(bit), pk)
        print(f"3. Encrypted bit {bit} "
              f"(budget {float(ct.noise_budget):.1f} bits)")

        fresh = fhe.bootstrap_binary(ct, sk, bsk)
        got = int(fhe.decrypt(fresh, sk).data[0])
        status = "OK" if got == bit else "MISMATCH"
        print(f"   bootstrap -> decrypts to {got}  [{status}]  "
              f"(budget {float(fresh.noise_budget):.1f} bits)\n")
        ok &= got == bit

    # programmable bootstrap: squaring mod 5 on a 2-bit payload, evaluated
    # during the refresh (the binary refresh above is its lut=[0,1] case)
    lut = [(m * m) % 5 for m in range(4)]
    print(f"4. Programmable bootstrap: lut = {lut} (m -> m^2 mod 5)")
    for m in range(4):
        ct = fhe.encrypt(coeff_plaintext(m), pk)
        out = fhe.bootstrap_lut(ct, lut, sk, bsk)
        got = int(fhe.decrypt(out, sk).data[0])
        status = "OK" if got == lut[m] else "MISMATCH"
        print(f"   lut[{m}] -> {got}  [{status}]")
        ok &= got == lut[m]
    print()

    print("=== " + ("Example completed successfully!"
                    if ok else "EXAMPLE FAILED") + " ===")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
