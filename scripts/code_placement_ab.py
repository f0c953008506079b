#!/usr/bin/env python3
"""multiply_batch at B = 8 before and after the first ntt_inverse and
ks_inner launches of a process, on one NVIDIA card, for one tree of the
port per run:

    python3 scripts/code_placement_ab.py [TREE]

The CUDA driver loads a kernel's code when the kernel first launches (lazy
module loading, PyTorch's default), so the kernels a process launches first
decide where the code of later ones lies in device memory.  A tree whose
ntt_inverse or ks_inner kernel is larger moves the code of every kernel
first launched after them.  This script keeps multiply_batch's kernels
ahead of both: it encodes on the CPU, makes the keys and encrypts on the
card (none of which launches ntt_inverse or ks_inner), times multiply_batch
(device ms as in torch_ab.py, and a torch.profiler trace of 20 calls with
each kernel's duration), then launches ntt_inverse (encode on the card) and
ks_inner_batch (a hoisted rotation) and times it again.  It prints one JSON
line: the card's name and power limit, the tree, CUDA_MODULE_LOADING, and
both timings.  Run it once per tree, in turns (A, B, B, A).  Imports no JAX
and nothing of fhe_tpu.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_ab  # noqa: E402  (imports the tree's fhe_tpu_torch)

from fhe_tpu_torch import FHE  # noqa: E402
from fhe_tpu_torch.ops import ntt_cuda  # noqa: E402
from fhe_tpu_torch.scheme.encoder import BatchEncoder  # noqa: E402
from fhe_tpu_torch.scheme.types import Plaintext  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("code_placement_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    fhe = FHE(poly_degree=torch_ab.N, log_q=torch_ab.LOG_Q, hamming_weight=torch_ab.H, seed=3,
              device="cuda")
    host = BatchEncoder(fhe.params, device="cpu")
    card_pt = lambda vals: Plaintext(data=host.encode(vals).data.to("cuda"))
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    cts_a = fhe.encrypt_batch([card_pt([5 + i, 10]) for i in range(torch_ab.BATCH)], pk)
    cts_b = fhe.encrypt_batch([card_pt([3, 6 + i]) for i in range(torch_ab.BATCH)], pk)
    fn = lambda: fhe.multiply_batch(cts_a, cts_b, rlk)
    if ntt_cuda.ntt_inverse.launches or ntt_cuda.ks_inner_batch.galois_launches:
        raise RuntimeError("ntt_inverse or ks_inner_batch launched before multiply_batch")
    out = {"card": card, "tree": str(torch_ab.TREE),
           "cuda_module_loading": os.environ.get("CUDA_MODULE_LOADING"),
           "before": {"device_ms": torch_ab.device_ms(fn), "trace": torch_ab.trace(fn)}}
    gk = fhe.galoiskey_gen(sk, elements=(3, 9))
    fhe.rotate_rows_hoisted(fhe.encrypt(fhe.encode([1, 2]), pk), (1, 2), gk)
    torch.cuda.synchronize()
    if not (ntt_cuda.ntt_inverse.launches and ntt_cuda.ks_inner_batch.galois_launches):
        raise RuntimeError("ntt_inverse and ks_inner_batch's Galois lane were expected "
                           "to launch")
    out["after"] = {"device_ms": torch_ab.device_ms(fn), "trace": torch_ab.trace(fn)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
