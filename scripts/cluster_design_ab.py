#!/usr/bin/env python3
"""Design A/B of the cluster kernels keyswitch_fused (B7/B12), ntt_forward
(B1), ntt_inverse (B2) and ks_inner_batch / ks_inner_grouped (B17/B18) on
one NVIDIA card, for one tree of the port per run:

    python3 scripts/cluster_design_ab.py [TREE] [--sass]

TREE (default: the checkout this script lies in) is the root of a checkout
whose fhe_tpu_torch package is imported, and whose kernels are built, for
the run.  Run it once per tree, in turns (A, B, B, A), to compare trees
that differ in a kernel's design.  It prints one JSON line: the card's name
and power limit, the tree, and
  - keyswitch_pairs: device ms (median of 25, CUDA events with the card kept
    busy) of keyswitch_fused_batch at each digit-pair count R from 2 to the
    tree's ntt_cuda.KEYSWITCH_PAIRS (a cluster of 2R CTAs), launched through
    the C entry point, at k = 3, kd = 3 (B = 1, 8, 24), k = 8, kd = 8
    (B = 1, 8), the prereduced k = 8, kd = 4 (B = 1, 8), n = 16384 and
    n = 256 (k = 5, kd = 5); each result equals the plain twin.  Absent for
    a tree whose key switch takes no pair count;
  - ntt_forward and ntt_inverse: device ms of each through the wrapper at
    [3, B, 8192] for B = 1, 3, 16, 48, at [3, B, 32768] for B = 1, 16, and
    (ntt_inverse) the encoder's [1, 1, 8192] mod t = 65537; each result
    equals the plain twin (null where a tree raises);
  - ks_inner: device ms of ks_inner_batch (one digit stack shared by 8 key
    sets, the hoisted rotations; kd = 3 at k = 3, kd = 8 at k = 8) and of
    ks_inner_grouped (4 stacks by 8 key sets) at n = 8192, each equal to
    the plain twin;
  - keyswitch_after: the key switch's own duration in a torch.profiler trace
    (µs, median of 20) when it runs alone, behind a small elementwise op,
    behind tensor_product, behind ntt_inverse, behind ks_inner_batch, and
    behind a 64 MB memset that evicts the L2 cache, at n = 256 (k = 5,
    kd = 5) and at n = 8192 (k = 3, kd = 3);
  - sass_instructions: the SASS instructions of each kernel in the tree's
    libraries (cuobjdump -sass), the code a cold SM fetches, and
    sass_digest: a digest of each kernel's instructions (addresses and
    encodings left out), equal across trees where the compiler emitted the
    same code for it.
With --sass it prints only the card, the tree and the two SASS fields.
Imports no JAX and nothing of fhe_tpu.
"""

from __future__ import annotations

import hashlib
import json
import re
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import torch

ARGS = [a for a in sys.argv[1:] if not a.startswith("--")]
TREE = Path(ARGS[0] if ARGS else Path(__file__).resolve().parent.parent)
SASS_ONLY = "--sass" in sys.argv[1:]
sys.path.insert(0, str(TREE.resolve()))

from fhe_tpu_torch import primes  # noqa: E402
from fhe_tpu_torch.ops import _build, ntt_cuda  # noqa: E402
from fhe_tpu_torch.ops import ntt as plain  # noqa: E402
from fhe_tpu_torch.params import SecurityParams, make_scheme_params  # noqa: E402


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


GEN = torch.Generator(device="cuda").manual_seed(3)


def residues(moduli, rows: int, n: int) -> torch.Tensor:
    return torch.stack([torch.randint(0, int(p), (rows, n), generator=GEN, device="cuda",
                                      dtype=torch.int64) for p in moduli]).to(torch.int32)


def q_tables(n: int, log_q: int):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        prm = make_scheme_params(SecurityParams(poly_degree=n, log_q=log_q, hamming_weight=32))
    return plain.build_tables(n, prm.q_primes, "cuda")


def keyswitch_inputs(tb, kd: int, batch: int, prereduced: bool):
    n = tb.n
    keys_t = torch.stack([residues(tb.primes, 2, n) for _ in range(kd)]).permute(1, 0, 2, 3)
    if prereduced:
        return residues(tb.primes, kd * batch, n).view(tb.k, kd, batch, n), keys_t
    return torch.stack([residues((q,), batch, n)[0] for q in tb.primes[:kd]]), keys_t


def keyswitch_at(d, keys_t, tb, prereduced: bool, pairs: int) -> torch.Tensor:
    """keyswitch_fused_batch through the C entry point with R = pairs."""
    kd, batch, n = d.shape[-3:]
    geo = ntt_cuda.keyswitch_geometry(n, tb.k, kd, batch)
    out = torch.empty((tb.k, 2, batch, n), dtype=torch.int32, device=d.device)
    p = _build.ptr
    _build.launch(ntt_cuda._lib().fhe_keyswitch, "keyswitch_fused_batch", d.device, p(d),
                  d.stride(0) if prereduced else 0, d.stride(-3), d.stride(-2), p(keys_t),
                  keys_t.stride(0), keys_t.stride(1), p(out), *ntt_cuda.table_ptrs(tb), tb.k,
                  kd, batch, ntt_cuda.log2_exact(n), pairs, geo["threads"], geo["smem"],
                  int(prereduced), 0, None, 0, 0, 0, None, 0)
    return out


def keyswitch_pairs() -> dict:
    out = {}
    for n, log_q, kd, batch, prereduced in (
            (8192, 90, 3, 1, False), (8192, 90, 3, 8, False), (8192, 90, 3, 24, False),
            (8192, 218, 8, 1, False), (8192, 218, 8, 8, False), (8192, 218, 4, 1, True),
            (8192, 218, 4, 8, True), (16384, 90, 3, 1, False), (256, 150, 5, 1, False)):
        tb = q_tables(n, log_q)
        d, keys_t = keyswitch_inputs(tb, kd, batch, prereduced)
        want = plain.keyswitch_fused_batch(d, keys_t, tb, prereduced)
        row = {}
        for pairs in range(2, min(max(kd, 2), ntt_cuda.KEYSWITCH_PAIRS) + 1):
            fn = lambda pairs=pairs: keyswitch_at(d, keys_t, tb, prereduced, pairs)
            if not torch.equal(fn(), want):
                raise RuntimeError(f"keyswitch n={n} kd={kd} B={batch} R={pairs} differs")
            row[f"R={pairs}"] = device_ms(fn)
        lane = " prereduced" if prereduced else ""
        out[f"n={n} k={tb.k} kd={kd} B={batch}{lane}"] = row
    return out


def transform(name: str) -> dict:
    """ntt_forward or ntt_inverse at [3, B, n], and ntt_inverse at the
    encoder's [1, 1, 8192] mod t."""
    out = {}
    cases = [(tuple(primes.find_ntt_primes(n, 3)), n, batch)
             for n, batches in ((8192, (1, 3, 16, 48)), (32768, (1, 16))) for batch in batches]
    if name == "ntt_inverse":
        cases.append(((65537,), 8192, 1))
    for moduli, n, batch in cases:
        tb = plain.build_tables(n, moduli, "cuda")
        x = residues(moduli, batch, n)
        fn = lambda x=x, tb=tb: getattr(ntt_cuda, name)(x, tb)
        label = f"[{len(moduli)},{batch},{n}]" + (" mod t" if len(moduli) == 1 else "")
        try:
            got = fn()
        except (ValueError, RuntimeError) as err:      # a tree that does not take n
            print(f"cluster_design_ab: {name} {label} raised: {err}", file=sys.stderr)
            out[label] = None
            continue
        if not torch.equal(got, getattr(plain, name)(x, tb)):
            raise RuntimeError(f"{name} {label} differs")
        out[label] = device_ms(fn)
    return out


def ks_inner_inputs(tb, kd: int, stacks: int, key_sets: int):
    n = tb.n
    return (residues(tb.primes, kd * stacks, n).view(tb.k, kd, stacks, n),
            residues(tb.primes, kd * key_sets * 2, n).view(tb.k, kd, key_sets, 2, n))


def ks_inner() -> dict:
    out = {}
    for log_q, kd, stacks, grouped in ((90, 3, 1, False), (218, 8, 1, False),
                                       (90, 3, 4, True)):
        tb = q_tables(8192, log_q)
        dg, keys = ks_inner_inputs(tb, kd, stacks, 8)
        name = "ks_inner_grouped" if grouped else "ks_inner_batch"
        fn = lambda name=name, dg=dg, keys=keys, tb=tb: getattr(ntt_cuda, name)(dg, keys, tb)
        if not torch.equal(fn(), getattr(plain, name)(dg, keys, tb)):
            raise RuntimeError(f"{name} k={tb.k} kd={kd} differs")
        out[f"{name} k={tb.k} kd={kd} stacks={stacks} key_sets=8"] = device_ms(fn)
    return out


def traced_us(seq, name_part: str, reps: int = 20) -> float:
    """Median duration (µs) of the kernels named name_part in a profiler
    trace of seq run reps times, queued behind a busy card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in seq:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(int(20e-3 * 2.0e9))
        for _ in range(reps):
            for fn in seq:
                fn()
        torch.cuda.synchronize()
    return statistics.median(e.time_range.end - e.time_range.start for e in prof.events()
                             if e.device_type == DeviceType.CUDA and name_part in e.name)


def keyswitch_after() -> dict:
    out = {}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for n, log_q, kd in ((256, 150, 5), (8192, 90, 3)):
        tb = q_tables(n, log_q)
        d, keys_t = keyswitch_inputs(tb, kd, 1, False)
        d = d[:, 0]
        x, y, row = residues(tb.primes, 2, n), residues(tb.primes, 2, n), residues(tb.primes, 1, n)
        dg, keys = ks_inner_inputs(tb, kd, 1, 8)
        ks = lambda: ntt_cuda.keyswitch_fused(d, keys_t, tb)
        seqs = {"alone": [ks], "after_add": [lambda: row.add_(1), ks],
                "after_tensor_product": [lambda: ntt_cuda.tensor_product(x, y, tb), ks],
                "after_ntt_inverse": [lambda: ntt_cuda.ntt_inverse(row, tb), ks],
                "after_ks_inner": [lambda: ntt_cuda.ks_inner_batch(dg, keys, tb), ks],
                "after_l2_flush": [lambda: flush.zero_(), ks]}
        out[f"n={n} kd={kd}"] = {what: traced_us(seq, "keyswitch") for what, seq in seqs.items()}
    return out


def sass_instructions() -> tuple[dict, dict] | None:
    """SASS instruction count per kernel of each of the tree's libraries,
    and a digest of each kernel's instruction text (the /*address*/ and
    encoding comments left out), or None where the toolkit has no
    cuobjdump.  A template kernel's name carries its arguments' numbers
    (<0>, <2,1,7>, ...)."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    _build.load_all()
    code, cur = {}, None
    for lib in _build.SOURCES:
        text = subprocess.run([str(tool), "-sass", str(_build.build_dir() / f"lib{lib}.so")],
                              capture_output=True, text=True, check=True, timeout=300).stdout
        for line in text.splitlines():
            m = re.search(r"Function : \S*?([a-z_]+_kernel)(?:I(.*?)EEv)?", line)
            if m:
                args = re.findall(r"(?:Li|Lb|E)(\d+)E", m[2] or "")
                cur = m[1] + (f"<{','.join(args)}>" if args else "")
                code[cur] = []
            elif cur and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
                code[cur].append(re.sub(r"/\*.*?\*/", "", line).strip())
    return ({name: len(v) for name, v in code.items()},
            {name: hashlib.sha256("\n".join(v).encode()).hexdigest()[:16]
             for name, v in code.items()})


def main() -> int:
    if not torch.cuda.is_available():
        print("cluster_design_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    out = {"card": card, "tree": str(TREE)}
    sass = sass_instructions()
    out["sass_instructions"], out["sass_digest"] = sass or (None, None)
    if SASS_ONLY:
        print(json.dumps(out))
        return 0
    if hasattr(ntt_cuda, "keyswitch_geometry"):
        out["keyswitch_pairs"] = keyswitch_pairs()
    out["ntt_forward"] = transform("ntt_forward")
    out["ntt_inverse"] = transform("ntt_inverse")
    out["ks_inner"] = ks_inner()
    out["keyswitch_after"] = keyswitch_after()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
