#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (fhe_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device: the card's name and power limit (nvidia-smi), torch, nvcc;
  2. build: every CUDA kernel from fhe_tpu_torch/csrc/, with its time;
  3. kernels: each kernel against its plain PyTorch version on the card at
     n = 8192, k = 3, bit-exact (tolerance 0), with device times (CUDA
     events, median of 25 launches after warm-up), the plain version's time
     and the least time the card could take (bound);
  4. slice: the linear-ops main path through the FHE facade at n = 8192,
     log_q = 90 (k = 3), h = 64: keygen, encode, encrypt, add, add_plain and
     the 8-term resident plaintext multiply-accumulate, then decrypt and
     decode.  Every launch count is zeroed just before and read just after;
     each kernel must have launched.  The decoded slots must be [8,16,24,32]
     and 180, and the card's results must equal the plain path's on the CPU
     bit for bit.  Then end-to-end times of each op.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Any failure raises and exits nonzero; without
a card the script exits 1 before printing any result.  Imports no JAX and
nothing of fhe_tpu.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

import torch

from fhe_tpu_torch import FHE
from fhe_tpu_torch.ops import _build, decrypt_cuda, ntt_cuda
from fhe_tpu_torch.ops import ntt as plain_ntt
from fhe_tpu_torch.ops import rns, sampling
from fhe_tpu_torch.params import SecurityParams, make_scheme_params
from fhe_tpu_torch.scheme import bfv
from fhe_tpu_torch.scheme.context import make_context
from fhe_tpu_torch.scheme.types import Plaintext, SecretKey

N, LOG_Q, H = 8192, 90, 64
REPS = 25

# Published H100 SXM peaks (NVIDIA data sheet) at the full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer issue rate: 64 INT32 lanes per SM (half the 128 FP32 lanes
# behind the data sheet's 67 TFLOP/s), 132 SMs, 1.98 GHz boost clock.
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def helper_ops() -> dict[str, int]:
    """32-bit integer instructions per call of each modular helper, from the
    "OPS <helper> <count>" block beside the helpers in csrc/modmath.cuh."""
    text = (_build.CSRC / "modmath.cuh").read_text()
    ops = {m[1]: int(m[2]) for m in re.finditer(r"^//\s+OPS (\w+) (\d+)$", text, re.M)}
    want = {"add_mod", "sub_mod", "mul_shoup", "reduce_shoup", "mul_barrett",
            "reduce_barrett"}
    if set(ops) != want:
        raise RuntimeError(f"modmath.cuh OPS block lists {sorted(ops)}, expected "
                           f"{sorted(want)}")
    return ops


OPS = helper_ops()
OPS_BUTTERFLY = OPS["mul_shoup"] + OPS["add_mod"] + OPS["sub_mod"]

KERNELS = {
    "ntt_forward": dict(fn=ntt_cuda.ntt_forward, source="fhe_tpu_torch/csrc/ntt.cu",
                        replaces="fhe_tpu/ops/ntt_pallas.py:444"),
    "ntt_inverse": dict(fn=ntt_cuda.ntt_inverse, source="fhe_tpu_torch/csrc/ntt.cu",
                        replaces="fhe_tpu/ops/ntt_pallas.py:493"),
    "mul_by_ntt_operand": dict(fn=ntt_cuda.mul_by_ntt_operand,
                               source="fhe_tpu_torch/csrc/ntt.cu",
                               replaces="fhe_tpu/ops/ntt_pallas.py:576"),
    "decrypt_fused": dict(fn=decrypt_cuda.decrypt_fused,
                          source="fhe_tpu_torch/csrc/decrypt.cu",
                          replaces="fhe_tpu/ops/decrypt_pallas.py:126"),
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def reset_counts() -> None:
    for k in KERNELS.values():
        k["fn"].launches = 0


def device_ms(fn, reps: int = REPS) -> float:
    """Median device time of fn() in ms.  Before each launch the card is kept
    busy (torch.cuda._sleep) for longer than the host takes to queue the call,
    so the events bracket device work only, not host overhead."""
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
    """Median end-to-end time of fn() in ms as a caller sees it: CUDA events
    around the call, host work included, ending in a synchronise."""
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


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time in ms: bytes over the memory rate or integer operations over
    the issue rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ntt_work(k: int, batch: int, inverse: bool) -> tuple[float, float]:
    """(bytes, ops) of one [k, batch, N] transform: rows in and out, one
    twiddle table and its Shoup companions per prime."""
    logn = N.bit_length() - 1
    ops = k * batch * (N // 2) * logn * OPS_BUTTERFLY
    if inverse:
        ops += k * batch * N * OPS["mul_shoup"]
    return 4 * (2 * k * batch * N + 2 * k * N), ops


def mul_work(k: int, c: int) -> tuple[float, float]:
    logn = N.bit_length() - 1
    nbytes = 4 * (k * N + 2 * k * c * N + 4 * k * N)
    ops = k * ((N // 2) * logn * OPS_BUTTERFLY
               + c * (N * OPS["mul_barrett"] + (N // 2) * logn * OPS_BUTTERFLY
                      + N * OPS["mul_shoup"]))
    return nbytes, ops


def decrypt_work(k: int, batch: int) -> tuple[float, float]:
    logn = N.bit_length() - 1
    nbytes = 4 * (2 * k * batch * N + k * N + 4 * k * N + batch * N)
    o = OPS
    # per prime: forward and inverse sweeps, the key product, the n^-1 and
    # the phase/z/t-lane/gamma-lane step (decrypt.cu); then the epilogue
    per_prime = (2 * (N // 2) * logn * OPS_BUTTERFLY
                 + N * (o["mul_barrett"] + o["mul_shoup"] + o["add_mod"]
                        + 2 * o["mul_shoup"] + o["reduce_barrett"]
                        + o["mul_barrett"] + 2 * o["add_mod"]))
    epilogue = N * (2 * o["mul_shoup"] + o["mul_barrett"] + o["reduce_shoup"]
                    + 2 * o["sub_mod"])
    return nbytes, batch * (k * per_prime + epilogue)


def residues(gen: torch.Generator, moduli, rows: int) -> torch.Tensor:
    return torch.stack([torch.randint(0, int(p), (rows, N), generator=gen,
                                      device="cuda", dtype=torch.int64)
                        for p in moduli]).to(torch.int32)


def phase_device() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0])
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    info = {"device": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "python": sys.version.split()[0],
            "nvcc": nvcc.strip().splitlines()[-1]}
    print("phase device", json.dumps(info))


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load_all()
    dt = time.perf_counter() - t0
    out = _build.build_dir()
    usage = []
    for log in sorted(out.glob("*.log")):
        usage += [f"{log.stem}: {line.strip()}" for line in log.read_text().splitlines()
                  if "registers" in line or "spill" in line]
    print("phase build", json.dumps({"seconds": dt, "dir": out.name}))
    for line in usage:
        print("  ptxas", line)


def phase_kernels(gen: torch.Generator) -> dict:
    """Each kernel against its plain version on the same inputs, on the card."""
    prm = make_scheme_params(SecurityParams(poly_degree=N, log_q=LOG_Q,
                                            hamming_weight=H))
    qs, k = prm.q_primes, prm.k
    tb = plain_ntt.build_tables(N, qs, "cuda")
    cases = []   # (kernel, shape label, kernel call, plain call, (bytes, ops))
    for batch in (1, 16):
        x = residues(gen, qs, batch)
        cases.append(("ntt_forward", f"[{k},{batch},{N}]",
                      lambda x=x: ntt_cuda.ntt_forward(x, tb),
                      lambda x=x: plain_ntt.ntt_forward(x, tb),
                      ntt_work(k, batch, False)))
        cases.append(("ntt_inverse", f"[{k},{batch},{N}]",
                      lambda x=x: ntt_cuda.ntt_inverse(x, tb),
                      lambda x=x: plain_ntt.ntt_inverse(x, tb),
                      ntt_work(k, batch, True)))
    tt = plain_ntt.build_tables(N, (prm.t,), "cuda")
    xt = residues(gen, (prm.t,), 1)
    cases.append(("ntt_forward", f"t [1,1,{N}]", lambda: ntt_cuda.ntt_forward(xt, tt),
                  lambda: plain_ntt.ntt_forward(xt, tt), ntt_work(1, 1, False)))
    cases.append(("ntt_inverse", f"t [1,1,{N}]", lambda: ntt_cuda.ntt_inverse(xt, tt),
                  lambda: plain_ntt.ntt_inverse(xt, tt), ntt_work(1, 1, True)))
    u, w = residues(gen, qs, 1), residues(gen, qs, 2)
    cases.append(("mul_by_ntt_operand", f"u [{k},1,{N}] w [{k},2,{N}]",
                  lambda: ntt_cuda.mul_by_ntt_operand(u, w, tb),
                  lambda: plain_ntt.mul_by_ntt_operand(u, w, tb), mul_work(k, 2)))
    s = residues(gen, qs, 1)
    for t in (65537, 786433):
        dc = rns.make_decrypt(qs, t, prm.gamma, "cuda")
        # the main path's inputs first: both components as views of one
        # [k, 2, n] ciphertext, read in place
        ct = residues(gen, qs, 2)
        args = (ct[:, 0:1], ct[:, 1:2], s, tb, dc)
        cases.append(("decrypt_fused", f"t={t} views of [{k},2,{N}]",
                      lambda a=args: decrypt_cuda.decrypt_fused(*a),
                      lambda a=args: decrypt_cuda.decrypt_fused_plain(*a),
                      decrypt_work(k, 1)))
        for batch in (1, 8):
            c0, c1 = residues(gen, qs, batch), residues(gen, qs, batch)
            args = (c0, c1, s, tb, dc)
            cases.append(("decrypt_fused", f"t={t} [{k},{batch},{N}]",
                          lambda a=args: decrypt_cuda.decrypt_fused(*a),
                          lambda a=args: decrypt_cuda.decrypt_fused_plain(*a),
                          decrypt_work(k, batch)))
    results = {}
    for name, label, kern, plain, work in cases:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
        check(got.shape == want.shape and err == 0,
              f"{name} {label}: kernel differs from its plain version (max err {err})")
        ms, plain_ms = device_ms(kern), device_ms(plain)
        b_ms, b_by = bound(*work)
        row = {"shape": label, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by}
        print("phase kernel", name, json.dumps(row))
        results.setdefault(name, row)          # the first shape goes in the table
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout
    print("phase kernels clocks:", clocks.strip())
    return results


def run_slice(fhe: FHE):
    """The main path once: returns the decoded values and the state."""
    pk, sk = fhe.keygen()
    p1, p2 = fhe.encode([5, 10, 15, 20]), fhe.encode([3, 6, 9, 12])
    c1, c2 = fhe.encrypt(p1, pk), fhe.encrypt(p2, pk)
    added = fhe.decode(fhe.decrypt(fhe.add(c1, c2), sk))[:4]
    plain_added = fhe.decode(fhe.decrypt(fhe.add_plain(c1, p2), sk))[:4]
    pts = [fhe.encode([i + 1, 2 * i + 1, 3, 4]) for i in range(8)]
    ct = fhe.to_ntt(c1)
    acc = None
    for pt in pts:
        term = fhe.multiply_plain(ct, pt, cache_operand=True)
        acc = term if acc is None else fhe.add(acc, term)
    acc = fhe.to_coeff(acc)
    mac = fhe.decode(fhe.decrypt(acc, sk))
    return added, plain_added, mac, dict(pk=pk, sk=sk, p1=p1, c1=c1, pts=pts, acc=acc)


def phase_slice() -> dict:
    fhe = FHE(poly_degree=N, log_q=LOG_Q, hamming_weight=H, seed=0, device="cuda")
    check(fhe.params.k == 3, f"expected k = 3, got {fhe.params.k}")
    reset_counts()
    added, plain_added, mac, st = run_slice(fhe)
    torch.cuda.synchronize()
    launches = {name: k["fn"].launches for name, k in KERNELS.items()}
    print("phase slice launches", json.dumps(launches))
    check(list(added) == [8, 16, 24, 32], f"add decoded {list(added)}")
    check(list(plain_added) == [8, 16, 24, 32], f"add_plain decoded {list(plain_added)}")
    check(int(mac[0]) == 180, f"MAC slot 0 decoded {int(mac[0])}")
    for name, count in launches.items():
        check(count > 0, f"{name} was never launched on the main path")

    # the same state through the plain versions on the CPU, at full size
    cpu = make_context(fhe.params, device="cpu")
    to_cpu = lambda ct: ct.replace(data=ct.data.cpu())
    sk_cpu = SecretKey(data=st["sk"].data.cpu())
    for ct in (st["c1"], st["acc"]):
        got = fhe.decrypt(ct, st["sk"]).data.cpu()
        check(torch.equal(got, bfv.decrypt(cpu, to_cpu(ct), sk_cpu).data),
              "card decrypt differs from the CPU plain path")
    ct_cpu = bfv.to_ntt(cpu, to_cpu(st["c1"]))
    acc_cpu = None
    for pt in st["pts"]:
        pt_cpu = Plaintext(data=pt.data.cpu())
        term = bfv.multiply_plain(cpu, ct_cpu, pt_cpu,
                                  bfv.plain_ntt_operand(cpu, pt_cpu))
        acc_cpu = term if acc_cpu is None else bfv.add(cpu, acc_cpu, term)
    check(torch.equal(bfv.to_coeff(cpu, acc_cpu).data, st["acc"].data.cpu()),
          "card MAC differs from the CPU plain path")
    gen = torch.Generator(device="cuda").manual_seed(9)
    primes = fhe.ctx.ntt_q.p
    s, a, e = (sampling.ternary_rns(gen, primes, 1, N, H),
               sampling.uniform_rns(gen, primes, 1, N),
               sampling.gaussian_rns(gen, primes, 3.2, 1, N))
    pk_card, sk_card = bfv.keygen_from_noise(fhe.ctx, s, a, e)
    pk_cpu, sk_cpu2 = bfv.keygen_from_noise(cpu, s.cpu(), a.cpu(), e.cpu())
    check(torch.equal(pk_card.data.cpu(), pk_cpu.data)
          and torch.equal(sk_card.data.cpu(), sk_cpu2.data),
          "card keygen differs from the CPU plain path")
    # u = s and e1 = e2 = e: any residues serve to compare the two paths
    enc_card = bfv.encrypt_from_noise(fhe.ctx, pk_card, st["p1"], s, e, e)
    enc_cpu = bfv.encrypt_from_noise(cpu, pk_cpu, Plaintext(data=st["p1"].data.cpu()),
                                     s.cpu(), e.cpu(), e.cpu())
    check(torch.equal(enc_card.data.cpu(), enc_cpu.data),
          "card encrypt differs from the CPU plain path")
    print("phase slice check: decoded [8,16,24,32] twice and 180; card == CPU plain path "
          "for keygen, encrypt, the MAC and decrypt")

    pk, sk, p1, c1, pts = st["pk"], st["sk"], st["p1"], st["c1"], st["pts"]
    ops = [fhe.plain_operand(pt) for pt in pts]
    ct_ntt = fhe.to_ntt(c1)

    def mac8():
        ct = fhe.to_ntt(c1)
        acc = None
        for pt, op in zip(pts, ops):
            term = bfv.multiply_plain(fhe.ctx, ct, pt, op)
            acc = term if acc is None else fhe.add(acc, term)
        return fhe.to_coeff(acc)

    timings = {
        "keygen": wall_ms(fhe.keygen),
        "encode": wall_ms(lambda: fhe.encode([5, 10, 15, 20])),
        "encrypt": wall_ms(lambda: fhe.encrypt(p1, pk)),
        "add": wall_ms(lambda: fhe.add(c1, c1)),
        "add_plain": wall_ms(lambda: fhe.add_plain(c1, p1)),
        "to_ntt": wall_ms(lambda: fhe.to_ntt(c1)),
        "multiply_plain_resident": wall_ms(
            lambda: bfv.multiply_plain(fhe.ctx, ct_ntt, pts[0], ops[0])),
        "mac8_resident": wall_ms(mac8),
        "decrypt": wall_ms(lambda: fhe.decrypt(c1, sk)),
        "decode": wall_ms(lambda: fhe.decode(p1)),
    }
    print("phase slice wall_ms", json.dumps(timings))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    results = phase_kernels(gen)
    launches = phase_slice()
    rows = []
    for name, meta in KERNELS.items():
        r = results[name]
        rows.append({"name": name, "route": "cuda", "source": meta["source"],
                     "replaces": meta["replaces"], "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": None,
                     "shape": r["shape"]})
    print("phase total seconds", time.perf_counter() - t_start)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
