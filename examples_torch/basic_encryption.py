#!/usr/bin/env python3
"""Basic Encryption Example on the PyTorch port — keygen, encode, encrypt,
decrypt, decode.

The port's copy of ``examples/basic_encryption.py``: the same parameters
(lambda=128, N=4096, log q=120), seed and data {42, 100, 255, 1337}, and the
same contract: exit 0 iff decrypt(encrypt(m)) == m.  Runs on
FHE_EXAMPLE_DEVICE (default "cuda"; "cpu" runs the plain PyTorch versions
of the kernels) at FHE_EXAMPLE_POLY_DEGREE (default 4096).

    python examples_torch/basic_encryption.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from fhe_tpu_torch import FHE


def main() -> int:
    print("=== FHE Basic Encryption Example ===\n")

    print("1. Setting up parameters...")
    degree = int(os.environ.get("FHE_EXAMPLE_POLY_DEGREE", "4096"))
    device = os.environ.get("FHE_EXAMPLE_DEVICE", "cuda")
    fhe = FHE(lambda_=128, poly_degree=degree, log_q=120, sigma=3.2,
              hamming_weight=64, seed=2024, device=device)
    print(f"   Device: {fhe.device}")
    print(f"   Security level: {fhe.params.security.lambda_} bits")
    print(f"   Polynomial degree: {fhe.params.n}")
    print(f"   RNS primes: {fhe.params.k} x ~30 bits\n")

    print("2. Generating keys...")
    pk, sk = fhe.keygen()
    print("   Keys generated successfully!\n")

    data = [42, 100, 255, 1337]
    print(f"3. Preparing plaintext data...\n   Original data: {data}\n")

    print("4. Encoding plaintext...")
    pt = fhe.encode(data)
    print("   Data encoded into polynomial (SIMD slots)\n")

    print("5. Encrypting...")
    ct = fhe.encrypt(pt, pk)
    budget = fhe.estimate_noise_budget(ct, sk)
    print("   Data encrypted successfully!")
    print(f"   Ciphertext has {ct.num_components} components")
    print(f"   Initial noise budget: {budget:.1f} bits\n")

    print("6. Decrypting...")
    pt_result = fhe.decrypt(ct, sk)
    print("   Data decrypted successfully!\n")

    print("7. Decoding result...")
    decrypted = fhe.decode(pt_result)[: len(data)]
    print(f"   Decrypted data: {list(map(int, decrypted))}\n")

    print("8. Verifying correctness...")
    if np.array_equal(decrypted, np.array(data, dtype=decrypted.dtype)):
        print("   OK: all values match — encryption/decryption successful!\n")
    else:
        print(f"   FAIL: expected {data}, got {list(map(int, decrypted))}\n")
        return 1

    print("=== Example Complete ===")
    return 0


if __name__ == "__main__":
    sys.exit(main())
