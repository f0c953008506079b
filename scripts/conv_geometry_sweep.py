#!/usr/bin/env python3
"""Launch shapes of the base-conversion kernel (csrc/rns.cu base_conv_kernel)
on one NVIDIA card, for choosing ops/rns_cuda.py's conv_geometry:

    python3 scripts/conv_geometry_sweep.py

For fast_bconv_sk_fused with the digits lane at the four shapes the paths
give it (n = 8192: [5,3,n] the headline multiply, [5,24,n] its
multiply_batch at B = 8, [10,3,n] the k8 / k8_omega multiply, [10,24,n]
their batch), the lane without digits at [5,3,n], and the FloorSK lane of
fast_floor_fused at the n = 256, k = 5 multiply's shapes (levels 0 and 2),
it forces each words-per-thread count the kernel is built for (1 or 2 in
the SK lane, 1 in the floor lanes) and 128 or 256 threads per CTA,
checks the result against the plain twin (tolerance 0) and prints one JSON
line per case: device ms (CUDA events, median of 25, the card kept busy as
in torch_ab.py) and the kernel's own duration from a torch.profiler trace
of 20 launches, beside the shape conv_geometry picks.  The first line is
the card's name and power limit.  Imports no JAX and nothing of fhe_tpu.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_ab  # noqa: E402  (imports this tree's fhe_tpu_torch)

from fhe_tpu_torch.ops import rns, rns_cuda  # noqa: E402

N = 8192


def cases(gen: torch.Generator) -> list:
    """(label, lane, kernel call, plain call, count per row)."""
    out = []
    for log_q, rows in ((90, 3), (90, 24), (218, 3), (218, 24)):
        ctx = torch_ab.quiet_context(N, log_q, torch_ab.H)
        kb, k = ctx.mul_tables[1].k, ctx.k
        xb = torch_ab.residues(gen, ctx.params.bsk_primes, rows)
        dig = (ctx.inv_qhat_levels[0], ctx.inv_qhat_shoup_levels[0])
        label = f"sk digits [{kb},{rows},{N}] -> [{k},{rows},{N}]"
        out.append((label, "sk",
                    lambda x=xb, c=ctx, d=dig: rns_cuda.fast_bconv_sk_fused(x, c.sk_c, d),
                    lambda x=xb, c=ctx, d=dig: rns.fast_bconv_sk_digits(x, c.sk_c, d[0]),
                    rows * N))
        if (log_q, rows) == (90, 3):
            out.append((f"sk [{kb},3,{N}]", "sk",
                        lambda x=xb, c=ctx: rns_cuda.fast_bconv_sk_fused(x, c.sk_c),
                        lambda x=xb, c=ctx: rns.fast_bconv_sk(x, c.sk_c), 3 * N))
    ctx = torch_ab.quiet_context(256, 150, 32)
    for level in (0, 2):
        qs, tbsk = ctx.ntt_q.primes[:ctx.k - level], ctx.mul_levels[level][1]
        tx_q = torch_ab.residues(gen, qs, 3, 256)
        tx_b = torch_ab.residues(gen, tbsk.primes, 3, 256)
        fc, sk = ctx.floor_levels[level], ctx.sk_levels[level]
        dig = (ctx.inv_qhat_levels[level], ctx.inv_qhat_shoup_levels[level])
        out.append((f"floor_sk digits n=256 level {level} [{len(qs)},3,256] + "
                    f"[{tbsk.k},3,256]", "floor_sk",
                    lambda a=tx_q, b=tx_b, f=fc, s=sk, d=dig:
                    rns_cuda.fast_floor_fused(a, b, f, s, d),
                    lambda a=tx_q, b=tx_b, f=fc, s=sk, d=dig:
                    rns.fast_floor_sk(a, b, f, s, d[0]), 3 * 256))
    return out


def same(got, want) -> bool:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))


def main() -> int:
    if not torch.cuda.is_available():
        print("conv_geometry_sweep: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0])
    gen = torch.Generator(device="cuda").manual_seed(17)
    picked = rns_cuda.conv_geometry
    for label, lane, kern, plain, count in cases(gen):
        chosen = picked(count, lane)
        shapes = [(v, t) for v in ((1, 2) if lane == "sk" else (1,)) for t in (128, 256)]
        for v, threads in shapes:
            forced = {"per_thread": v, "threads": threads,
                      "blocks": -(-count // (v * threads))}
            rns_cuda.conv_geometry = lambda c, ln, f=forced: f
            try:
                ok = same(kern(), plain())
                torch.cuda.synchronize()
                if not ok:
                    raise RuntimeError(f"{label} per_thread={v} threads={threads}: "
                                       "kernel differs from its plain twin")
                row = {"case": label, "per_thread": v, "threads": threads,
                       "picked": (chosen["per_thread"], chosen["threads"]) == (v, threads),
                       "device_ms": torch_ab.device_ms(kern),
                       "profiler_us": torch_ab.trace(kern)["kernels"][0]["us"]}
            finally:
                rns_cuda.conv_geometry = picked
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
