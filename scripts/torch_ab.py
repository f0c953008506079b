#!/usr/bin/env python3
"""Device and end-to-end times of the port's multiply, encrypt and decrypt on
one NVIDIA card, for comparing two trees of the port (a parent and a change)
within one run on the card:

    python3 scripts/torch_ab.py [TREE] [--lanes | --bootstrap | --host | --mxu]

TREE (default: the checkout this script lies in) is the root of a checkout
whose fhe_tpu_torch package is imported, and whose kernels are built, for
the run.  Run it once per tree, in the order parent, change, change, parent.
It prints one JSON line: the card's name and power limit, the tree, and at
the headline configuration (n = 8192, log_q = 90, k = 3, kb = 5):
  - device_ms (CUDA events while the card is kept busy, so host work is
    excluded; median of 25) and wall_ms (CUDA events around the call, host
    work included; median of 10) of keygen, multiply_no_relin, relinearize,
    multiply, the decrypt of the product, encrypt, and decrypt_batch,
    encrypt_batch and multiply_batch at B = 8, with the batch ops also per
    ciphertext, and the multiply at the JAX bench's k8_omega (log_q = 218,
    k = 8, ks_omega = 2); and of the ops that launch ntt_inverse or
    ks_inner: encode, to_coeff of an NTT-form ciphertext, rotate_rows by 1
    of a coefficient-form and of an NTT-form ciphertext, galoiskey_gen of
    one element, rotate_rows_hoisted of the 8 steps 1..8 (the JAX bench's
    hoisted set) and its batch of 4 ciphertexts, sum_slots, and the key
    down-switch of relinearization keys to level 4 at the k8 configuration
    (log_q = 218, k = 8, ks_omega = 1; switch_relin_keys);
  - the device times of ntt_forward ([3,1,n], keygen's [3,3,n], [3,16,n],
    and the JAX bench's g_n32768 [3,1,32768], null where a tree raises
    there), ntt_inverse ([3,1,n], [3,16,n], the encoder's [1,1,n] mod
    t = 65537, and [3,1,32768], null where a tree raises there),
    keyswitch_fused (the relinearization's
    d [3,n] against keys [3,3,2,n]; at k = 8 with kd = 8; at n = 256, k = 5
    and n = 16384; the prereduced lane at k8_omega's k = 8, kd = 4), and
    keyswitch_fused_batch at B = 8 (both lanes), ks_inner_batch (a shared
    digit stack against 8 key sets) and ks_inner_grouped (4 stacks by 8 key
    sets);
  - the device times of mul_by_ntt_operand (encrypt's u [3,1,n] against
    pk [3,2,n]; batched at B = 8), tensor_product (the multiply's x, y
    [3,2,n] on the t-folded tables; batched on views of a [8,3,4,n] stack),
    bsk_branch_fused (single, and batched at B = 8) and decrypt_fused (on
    views of a [3, 2, n] ciphertext, and at B = 8) on random residues; and
    beside them bsk_branch_fused at the k8 configuration (log_q = 218,
    kb = 10), and mul_by_ntt_operand and tensor_product (the Bsk side) at
    the n < 1024 multiply's shapes (n = 256, log_q = 150, level 1);
  - device_ms of multiply_no_relin, relinearize and multiply at the n < 1024
    configuration (n = 256, log_q = 150, k = 5, h = 32; chip_smoke.py's
    small phase), multiply_no_relin at level 1, and the ntt_inverse
    launches of one such multiply;
  - lift_arms: that multiply's products, lift, floor and conversion to q,
    as (i) tensor_product on q, the standalone lift kernel, tensor_product
    on Bsk and fast_floor_fused, (ii) tensor_product's Lift lane and
    fast_floor_fused, (iii) tensor_product on q, bsk_branch_fused and
    fast_bconv_sk_fused (null where a tree lacks the arm), and the Lift
    lane alone beside tensor_product alone on q and on the Bsk base: device
    ms, kernels per call, span and idle share;
  - device_ms and wall_ms of the multiply at n = 16384 (the JAX bench's
    g_n16384: log_q = 90, k = 3, seed 4; multiply_relin_ms_n16384 and, at
    ks_omega = 2, multiply_relin_ms_n16384_omega2), and at n = 32768
    (tests/test_parallel.py:168-189: log_q = 90, k = 3, lambda_ = 0, h = 16,
    seed 11; multiply_relin_ms_n32768) and at the 128-bit n = 32768 set
    (log_q = 870, k = 29, kb = 32; multiply_relin_ms_secure128_n32768), and
    at n = 65536, log_q = 90, t = 786433 (multiply_relin_ms_n65536, null
    where a tree raises there),
    null for a tree whose multiply raises there;
  - bgv: at the JAX bench's g_bgv configuration (the headline one, seed 1,
    scheme="bgv"), device_ms and wall_ms of BGV's multiply, its halves,
    the decrypt of the product (the phase, then the centred lift onto {t}
    in torch ops), mod_switch_to_next and multiply_batch at B = 8, and a
    trace (below) of the multiply, the decrypt and the mod switch; null for
    a tree whose facade has no BGV;
  - bootstrap: at the JAX bench's g_bootstrap configuration (n = 1024,
    log_q = 120, k = 4, lambda_ = 0, h = 16, seed 5), wall_ms (median of 5)
    of bootstrap_binary of a level-0 bit and its time inside kernels from a
    torch.profiler trace of one call (host-bound, so events behind a busy
    card would time the host), the
    device_ms and wall_ms of one CMUX gate as the rotation calls it
    (scheme/bootstrap._cmux on a [2, k, n] accumulator) and the device_ms
    of the external product inside it (scheme/bootstrap._external_product;
    null where a tree's gate has another form) and, from torch.profiler
    traces of one
    blind_rotate over the first 16 secret coefficients and over none, the
    kernels per CMUX gate and per step (two gates), and the span, time in
    kernels and idle share of the 16 steps; null for a tree without the
    bootstrapping pipeline;
  - fast_bconv_sk_fused (B6) at the four shapes its paths give it ([5,3,n]
    the headline multiply, [5,24,n] its multiply_batch at B = 8, [10,3,n]
    the k8 multiply, [10,24,n] its batch) without the digits lane (both
    trees have it) and with it (null where a tree lacks it), and
    fast_floor_fused (B10) alone at [3,3,n] + [5,3,n] and at the n = 256
    multiply's level-1 shapes, and with the conversion to q and the digits
    there (null where a tree lacks it): device ms and each kernel's own
    duration from a torch.profiler trace of 20 launches;
  - device_ms and wall_ms of the multiply and device_ms of multiply_batch
    at B = 8 at the JAX bench's k8 (log_q = 218, k = 8, ks_omega = 1) and
    k8_omega (ks_omega = 2) configurations;
  - the rotations: device_ms and wall_ms of rotate_columns and
    rotate_rows_batch by 1 at B = 8, and a trace (below) of rotate_rows by
    1, rotate_columns, rotate_rows_batch, the 8 hoisted steps, their batch
    of 4 ciphertexts and sum_slots;
  - galois_lanes: the automorphisms with the key switch around them on
    random residues (a rotation at B = 1 and 8, the hoisted rotations'
    E = 8 and C x E = 4 x 8, a sum_slots stage at E = 3, also at k8_omega's
    k = 8, kd = 4): one launch of a Galois lane where the tree has it, else
    the parent's kernels for the same result; and
    ks_inner_batch / ks_inner_grouped without elements (E = 8, 4 x 8, and
    E = 3 with the hoisted lane at E = 3 beside it);
    device ms, kernels per call and span;
  - a torch.profiler trace of 20 multiplies at n = 256 (level 0) and at the
    headline configuration, and of
    20 multiply_batch calls at B = 8 at the headline configuration, queued
    behind a busy card so that the gaps between kernels are the device's
    own, not the host's: the kernels per call, each kernel's median
    device time and the median gap before it, and per call the span from
    the first kernel's start to the last one's end, the time inside
    kernels and the idle share of the span.
With --lanes it prints only the rotations' device ms and traces and
galois_lanes, for a design A/B of the lanes across trees (in turns); with
--bootstrap only the bootstrap entry; with --host only the wall and device
ms of the headline multiply, rotate_rows and sum_slots and the context
build times with and without the native library (host_main); with --mxu
only the mxu entry (mxu_main): the four-step int8 GEMM engine
(ops/ntt_mxu.py) against ntt_forward and the default multiply at the
headline configuration, under bench.py's names: forward_ntt_mxu_ms
([3,1,n]), forward_ntt_mxu_ms_batched ([3,64,n], per row),
multiply_relin_ms_mxu_engine (FHE(use_mxu=True)'s multiply, device and wall
ms), each beside ntt_forward's or the default multiply's, BGV's multiply
both ways, and traces (kernels per call, span, idle share) of both
multiplies; the engine's numbers are null for a tree without it.  The
timing methods are those of chip_smoke.py (device_ms, wall_ms).  Imports
no JAX and nothing of fhe_tpu.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import torch

ARGS = [a for a in sys.argv[1:] if not a.startswith("--")]
TREE = Path(ARGS[0] if ARGS else Path(__file__).resolve().parent.parent)
LANES_ONLY = "--lanes" in sys.argv[1:]
BOOTSTRAP_ONLY = "--bootstrap" in sys.argv[1:]
HOST_ONLY = "--host" in sys.argv[1:]
CONTEXT_BUILD = "--context-build" in sys.argv[1:]
MXU_ONLY = "--mxu" in sys.argv[1:]
sys.path.insert(0, str(TREE.resolve()))

from fhe_tpu_torch import FHE, primes  # noqa: E402
from fhe_tpu_torch.ops import decrypt_cuda, galois_cuda, ntt_cuda, rns_cuda  # noqa: E402
from fhe_tpu_torch.ops import modmath, ntt, rns  # noqa: E402
from fhe_tpu_torch.params import SecurityParams, make_scheme_params  # noqa: E402
from fhe_tpu_torch.scheme import bfv  # noqa: E402
from fhe_tpu_torch.scheme.context import make_context  # noqa: E402

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


def residues(gen: torch.Generator, moduli, rows: int, n: int = N) -> torch.Tensor:
    return torch.stack([torch.randint(0, int(p), (rows, n), generator=gen, device="cuda",
                                      dtype=torch.int64) for p in moduli]).to(torch.int32)


def quiet_context(n: int, log_q: int, h: int):
    """The context of a configuration below 128-bit security at this n (the
    warning silenced, as the JAX bench and tests do)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        prm = make_scheme_params(SecurityParams(poly_degree=n, log_q=log_q, hamming_weight=h))
    return make_context(prm, device="cuda")


def multiply_n16384(omega: int) -> dict | None:
    """device_ms and wall_ms of the n = 16384 multiply at ks_omega = omega,
    or None where this tree's multiply raises at that n."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        prm = make_scheme_params(SecurityParams(poly_degree=16384, log_q=LOG_Q,
                                                hamming_weight=H, ks_omega=omega))
    fhe = FHE(prm, seed=4, device="cuda")
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    a = fhe.encrypt(fhe.encode([5, 10]), pk)
    b = fhe.encrypt(fhe.encode([3, 6]), pk)
    try:
        prod = fhe.multiply(a, b, rlk)
    except ValueError as err:          # the parent: four rows per block
        print(f"torch_ab: n=16384 multiply raised: {err}", file=sys.stderr)
        return None
    got = [int(v) for v in fhe.decode(fhe.decrypt(prod, sk))[:2]]
    if got != [15, 60]:
        raise RuntimeError(f"n=16384 multiply decoded {got}")
    fn = lambda: fhe.multiply(a, b, rlk)
    return {"device_ms": device_ms(fn), "wall_ms": wall_ms(fn)}


def multiply_large(log_q: int = LOG_Q, n: int = 32768) -> dict | None:
    """device_ms and wall_ms of the multiply at n = 32768 or 65536, seed 11:
    at n = 32768, log_q = 90 tests/test_parallel.py:168-189's configuration
    (k = 3, lambda_ = 0, h = 16), at log_q = 870 the 128-bit set (k = 29,
    kb = 32, lambda_ = 128, h = 64); at n = 65536 chip_smoke.py's n65536
    sets (t = 786433, lambda_ = 0, h = 16); or None where this tree's
    multiply raises there."""
    kw = dict(lambda_=0, hamming_weight=16) if log_q == LOG_Q or n == 65536 else {}
    if n == 65536:
        kw["plain_modulus"] = 786433
    prm = make_scheme_params(SecurityParams(poly_degree=n, log_q=log_q, **kw))
    fhe = FHE(prm, seed=11, device="cuda")
    try:
        pk, sk = fhe.keygen()
        rlk = fhe.relinkey_gen(sk)
        a = fhe.encrypt(fhe.encode([4, 5, 6]), pk)
        b = fhe.encrypt(fhe.encode([7, 8, 9]), pk)
        prod = fhe.multiply(a, b, rlk)
    except ValueError as err:          # a tree without these launch shapes or bases
        print(f"torch_ab: n={n}, log_q={log_q} multiply raised: {err}", file=sys.stderr)
        return None
    got = [int(v) for v in fhe.decode(fhe.decrypt(prod, sk))[:3]]
    if got != [28, 40, 54]:
        raise RuntimeError(f"n={n} multiply decoded {got}")
    fn = lambda: fhe.multiply(a, b, rlk)
    return {"device_ms": device_ms(fn), "wall_ms": wall_ms(fn)}


def trace(fn) -> dict:
    """Per-kernel device times and the gaps between kernels of fn(), from a
    torch.profiler trace of 20 calls queued behind a busy card
    (torch.cuda._sleep), so that each kernel waits on the device, not on
    the host that launches it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    reps = 20
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(int(50e-3 * 2.0e9))
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # every kernel but the busy wait (torch.cuda._sleep's spin_kernel)
    kernels = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                     if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name)
    if not kernels or len(kernels) % reps:
        return {"kernels_traced": len(kernels), "note": "no whole calls in the trace"}
    per = len(kernels) // reps
    spans, busy = [], []
    by_pos = [{"dur": [], "gap": []} for _ in range(per)]
    for r in range(reps):
        run = kernels[r * per:(r + 1) * per]
        spans.append(run[-1][1] - run[0][0])
        busy.append(sum(e - s for s, e, _ in run))
        for j, (s, e, _) in enumerate(run):
            by_pos[j]["dur"].append(e - s)
            if j:
                by_pos[j]["gap"].append(s - run[j - 1][1])
    names = [name for _, _, name in kernels[:per]]
    span, inside = statistics.median(spans), statistics.median(busy)
    return {"kernels_per_call": per, "span_us": span, "in_kernels_us": inside,
            "idle_share": 1 - inside / span,
            "kernels": [{"name": names[j][:60], "us": statistics.median(p["dur"]),
                         "gap_before_us": statistics.median(p["gap"]) if p["gap"] else None}
                        for j, p in enumerate(by_pos)]}


def bgv_ops() -> dict | None:
    """BGV's multiply, decrypt, mod switch and multiply_batch at the
    headline width: device and wall ms, and traces (None where the tree's
    FHE takes no scheme)."""
    try:
        fhe = FHE(poly_degree=N, log_q=LOG_Q, hamming_weight=H, seed=1, scheme="bgv",
                  device="cuda")
    except TypeError:
        return None
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    cts_a = [fhe.encrypt(fhe.encode([5 + i, 10, 15, 20]), pk) for i in range(BATCH)]
    cts_b = [fhe.encrypt(fhe.encode([3, 6, 9, 12 + i]), pk) for i in range(BATCH)]
    a, b = cts_a[0], cts_b[0]
    m3 = fhe.multiply_no_relin(a, b)
    prod = fhe.multiply(a, b, rlk)
    got = [int(v) for v in fhe.decode(fhe.decrypt(prod, sk))[:4]]
    if got != [15, 60, 135, 240]:
        raise RuntimeError(f"BGV multiply decoded {got}")
    ops = {"multiply": lambda: fhe.multiply(a, b, rlk),
           "multiply_no_relin": lambda: fhe.multiply_no_relin(a, b),
           "relinearize": lambda: fhe.relinearize(m3, rlk),
           "decrypt_after_multiply": lambda: fhe.decrypt(prod, sk),
           "mod_switch_to_next": lambda: fhe.mod_switch_to_next(prod),
           "multiply_batch_B8": lambda: fhe.multiply_batch(cts_a, cts_b, rlk)}
    out = {"device_ms": {name: device_ms(fn) for name, fn in ops.items()},
           "wall_ms": {name: wall_ms(fn) for name, fn in ops.items()}}
    out["traces"] = {name: trace(ops[name]) for name in (
        "multiply", "decrypt_after_multiply", "mod_switch_to_next")}
    return out


def span_trace(fn) -> dict:
    """Device kernels of one call of fn(), as the host launches them (not
    queued behind a busy card): their count, the span from the first
    kernel's start to the last one's end, the time inside kernels and the
    idle share of the span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ks = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type == DeviceType.CUDA
                and not e.name.startswith(("Memcpy", "Memset")))
    span = ks[-1][1] - ks[0][0] if ks else 0.0
    inside = sum(e - s for s, e in ks)
    return {"kernels": len(ks), "span_us": span, "in_kernels_us": inside,
            "idle_share": 1 - inside / span if span else None}


def bootstrap_ops() -> dict | None:
    """bootstrap_binary at the JAX bench's g_bootstrap configuration: wall ms
    and time in kernels, the external product's device ms, and the kernels per CMUX
    from traces of a 16-step and a 0-step rotation (None where the tree has
    no bootstrapping pipeline)."""
    try:
        from fhe_tpu_torch.scheme import bootstrap
        from fhe_tpu_torch.scheme.types import BootstrapKey, LWECiphertext
    except ImportError:
        return None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fhe = FHE(poly_degree=1024, log_q=120, lambda_=0, hamming_weight=16, seed=5,
                  device="cuda")
    pk, sk = fhe.keygen()
    bsk = fhe.make_bootstrap_key(sk)
    ct = fhe.encrypt(fhe.encode_coeff([1]), pk)
    boot = lambda: fhe.bootstrap_binary(ct, sk, bsk)
    got = int(fhe.decode_coeff(fhe.decrypt(boot(), sk))[0])
    if got != 1:
        raise RuntimeError(f"bootstrap_binary decoded {got}")
    lwe = fhe.extract_lsb(ct)
    steps = 16
    bsk_t = BootstrapKey(pos=bsk.pos[:steps], neg=bsk.neg[:steps], level=0)
    rot = lambda m: bootstrap.blind_rotate(fhe.ctx, LWECiphertext(a=lwe.a[:m], b=lwe.b), bsk_t)
    tr, tr0 = span_trace(lambda: rot(steps)), span_trace(lambda: rot(0))
    per_cmux = (tr["kernels"] - tr0["kernels"]) / (2 * steps)
    return {"in_kernels_ms": span_trace(boot)["in_kernels_us"] / 1e3,
            "wall_ms": wall_ms(boot, reps=5), **cmux_gate(bootstrap, fhe.ctx, ct, bsk),
            "kernels_per_cmux": per_cmux, "kernels_per_step": 2 * per_cmux,
            f"trace_{steps}_steps": tr}


def cmux_gate(bootstrap, ctx, ct, bsk) -> dict:
    """device_ms and wall_ms (median of 50) of one CMUX gate as the rotation
    calls it, on a contiguous component-major [2, k, n] accumulator (as the
    rotation holds it), and device_ms of
    the external product inside it; null where the tree's gate has another
    form."""
    try:
        acc = ct.data.transpose(0, 1).contiguous()
        tb = bfv._tb(ctx, 0)
        p, inv = bootstrap._cmux_consts(tb, ctx.inv_qhat_levels[0], acc.dim())
        keys_t = bootstrap._keys_t(bsk.pos[0])
        idx = bootstrap._shift_table(ctx.n, acc.device)[5]
        gate = lambda: bootstrap._cmux(acc, idx, keys_t, tb, p, inv)
        ext = lambda: bootstrap._external_product(acc, keys_t, tb, p, inv)
        gate(), ext()
    except (AttributeError, TypeError) as err:
        print(f"torch_ab: no CMUX gate of this form: {err}", file=sys.stderr)
        return {"cmux_device_ms": None, "cmux_wall_ms": None,
                "external_product_device_ms": None}
    return {"cmux_device_ms": device_ms(gate), "cmux_wall_ms": wall_ms(gate, reps=50),
            "external_product_device_ms": device_ms(ext)}


def small_multiply() -> dict:
    """device_ms of the n = 256 multiply and its halves at level 0, and of
    multiply_no_relin at level 1."""
    fhe = FHE(make_scheme_params(SecurityParams(poly_degree=256, log_q=150,
                                                hamming_weight=32)), seed=29, device="cuda")
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    a = fhe.encrypt(fhe.encode([5, 10]), pk)
    b = fhe.encrypt(fhe.encode([3, 6]), pk)
    a1, b1 = fhe.mod_switch_to_next(a), fhe.mod_switch_to_next(b)
    m3 = fhe.multiply_no_relin(a, b)
    torch.cuda.synchronize()
    before = ntt_cuda.ntt_inverse.launches
    fhe.multiply(a, b, rlk)
    inverse_launches = ntt_cuda.ntt_inverse.launches - before
    return {"ntt_inverse_launches_per_multiply": inverse_launches,
            "multiply_no_relin": device_ms(lambda: fhe.multiply_no_relin(a, b)),
            "multiply_no_relin_l1": device_ms(lambda: fhe.multiply_no_relin(a1, b1)),
            "relinearize": device_ms(lambda: fhe.relinearize(m3, rlk)),
            "multiply": device_ms(lambda: fhe.multiply(a, b, rlk)),
            "trace": trace(lambda: fhe.multiply(a, b, rlk))}


def multiply_k8(omega: int) -> dict:
    """device_ms and wall_ms of the multiply, and device_ms of multiply_batch
    at B = 8, at the JAX bench's k8 (omega 1) or k8_omega (omega 2)
    configuration: n = 8192, log_q = 218, k = 8 (omega 2: the prereduced
    key switch)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        prm = make_scheme_params(SecurityParams(poly_degree=N, log_q=218, hamming_weight=H,
                                                ks_omega=omega))
    fhe = FHE(prm, seed=9, device="cuda")
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    a = fhe.encrypt(fhe.encode([5, 10]), pk)
    b = fhe.encrypt(fhe.encode([3, 6]), pk)
    got = [int(v) for v in fhe.decode(fhe.decrypt(fhe.multiply(a, b, rlk), sk))[:2]]
    if got != [15, 60]:
        raise RuntimeError(f"k8 (omega {omega}) multiply decoded {got}")
    fn = lambda: fhe.multiply(a, b, rlk)
    cts_a = fhe.encrypt_batch([fhe.encode([5 + i, 10]) for i in range(BATCH)], pk)
    cts_b = fhe.encrypt_batch([fhe.encode([3, 6 + i]) for i in range(BATCH)], pk)
    return {"device_ms": device_ms(fn), "wall_ms": wall_ms(fn),
            "multiply_batch_B8_device_ms": device_ms(
                lambda: fhe.multiply_batch(cts_a, cts_b, rlk))}


def digit_consts(ctx, level: int) -> tuple:
    """The digits lane's constants (an AttributeError in a tree without it)."""
    return ctx.inv_qhat_levels[level], ctx.inv_qhat_shoup_levels[level]


def conv_kernels(gen: torch.Generator) -> dict:
    """B6 and B10 on random residues: device ms and the kernel's own duration
    (torch.profiler) per shape, null where this tree lacks the lane."""
    calls = {}
    for log_q, rows in ((LOG_Q, 3), (LOG_Q, 3 * BATCH), (218, 3), (218, 3 * BATCH)):
        ctx = quiet_context(N, log_q, H)
        kb = ctx.mul_tables[1].k
        xb = residues(gen, ctx.params.bsk_primes, rows)
        calls[f"fast_bconv_sk_{kb}x{rows}"] = lambda x=xb, c=ctx: rns_cuda.fast_bconv_sk_fused(
            x, c.sk_c)
        calls[f"fast_bconv_sk_digits_{kb}x{rows}"] = (
            lambda x=xb, c=ctx: rns_cuda.fast_bconv_sk_fused(x, c.sk_c, digit_consts(c, 0)))
    ctx = quiet_context(N, LOG_Q, H)
    tx_q = residues(gen, ctx.ntt_q.primes, 3)
    tx_b = residues(gen, ctx.params.bsk_primes, 3)
    calls["fast_floor_3x3_5x3"] = lambda: rns_cuda.fast_floor_fused(tx_q, tx_b, ctx.floor_c)
    ctx_s = quiet_context(256, 150, 32)
    qs, bsk = ctx_s.ntt_q.primes[:ctx_s.k - 1], ctx_s.mul_levels[1][1].primes
    txq_s, txb_s = residues(gen, qs, 3, 256), residues(gen, bsk, 3, 256)
    fc, sk = ctx_s.floor_levels[1], ctx_s.sk_levels[1]
    calls["fast_floor_n256_l1"] = lambda: rns_cuda.fast_floor_fused(txq_s, txb_s, fc)
    calls["fast_floor_sk_digits_n256_l1"] = lambda: rns_cuda.fast_floor_fused(
        txq_s, txb_s, fc, sk, digit_consts(ctx_s, 1))
    out = {}
    for name, fn in calls.items():
        try:
            fn()
        except (AttributeError, TypeError) as err:      # a tree without the lane
            print(f"torch_ab: {name}: {err}", file=sys.stderr)
            out[name] = None
            continue
        out[name] = {"device_ms": device_ms(fn), "profiler_us": trace(fn)["kernels"][0]["us"]}
    return out


def lift_arms(gen: torch.Generator) -> dict:
    """The n < 1024 multiply's products, lift, floor and conversion at
    n = 256, k = 5, level 0, from the halves a, b [5, 2, 256] to the
    [5, 3, 256] result in q and the c2 digits, three ways (null where this
    tree lacks one): (i) tensor_product on q, the standalone lift
    (sm_mrq_fused) of cat(a, b), tensor_product on the Bsk base and
    fast_floor_fused with the conversion to q; (ii) tensor_product's Lift
    lane (``lift_products``) and the same fast_floor_fused; (iii)
    tensor_product on q, bsk_branch_fused and fast_bconv_sk_fused
    (multiply_batch's kernels at every n).  Device ms, and from a trace the
    kernels per call, the span and the idle share; and beside them the Lift
    lane alone, tensor_product alone on q and on the Bsk base, and the two
    after one another.  The arms' results must agree."""
    ctx = quiet_context(256, 150, 32)
    tq, tbsk = ctx.mul_levels[0]
    sc, fc, sk = ctx.smq_levels[0], ctx.floor_levels[0], ctx.sk_levels[0]
    dig = digit_consts(ctx, 0)
    a, b = residues(gen, tq.primes, 2, 256), residues(gen, tq.primes, 2, 256)
    lift = residues(gen, tbsk.primes, 4, 256)

    def lane():
        """The tree's Lift lane: both products in one launch, or (the design
        A/B's variant whose lane forms the Bsk side only) that lane alone."""
        try:
            return ntt_cuda.tensor_product(a, b, tq, lift=(sc, tbsk))
        except AttributeError:
            return ntt_cuda.tensor_product(a, b, tbsk, lift=sc)

    def lift_products():
        out = lane()
        return out if isinstance(out, tuple) else (ntt_cuda.tensor_product(a, b, tq), out)

    def chain():
        lifted = rns_cuda.sm_mrq_fused(torch.cat([a, b], dim=1), sc)
        tx_bsk = ntt_cuda.tensor_product(lifted[:, :2], lifted[:, 2:], tbsk)
        return rns_cuda.fast_floor_fused(ntt_cuda.tensor_product(a, b, tq), tx_bsk, fc, sk, dig)

    def branch():
        tx_q = ntt_cuda.tensor_product(a, b, tq)
        floored = rns_cuda.bsk_branch_fused(torch.cat([a, b], dim=1), tx_q, sc, fc, tbsk)
        return rns_cuda.fast_bconv_sk_fused(floored, sk, dig)

    arms = {"i_chain": chain,
            "ii_lane": lambda: rns_cuda.fast_floor_fused(*lift_products(), fc, sk, dig),
            "iii_bsk_branch": branch, "lane_alone": lane,
            "tensor_product_q": lambda: ntt_cuda.tensor_product(a, b, tq),
            "tensor_product_bsk": lambda: ntt_cuda.tensor_product(
                lift[:, :2], lift[:, 2:], tbsk),
            "tensor_product_q_then_bsk": lambda: (
                ntt_cuda.tensor_product(a, b, tq),
                ntt_cuda.tensor_product(lift[:, :2], lift[:, 2:], tbsk))}
    out, results = {}, {}
    for name, fn in arms.items():
        try:
            results[name] = fn()
        except (AttributeError, TypeError) as err:      # a tree without the arm
            print(f"torch_ab: {name}: {err}", file=sys.stderr)
            out[name] = None
            continue
        t = trace(fn)
        out[name] = {"device_ms": device_ms(fn), "kernels_per_call": t.get("kernels_per_call"),
                     "span_us": t.get("span_us"), "idle_share": t.get("idle_share")}
    done = [results[name] for name in ("i_chain", "ii_lane", "iii_bsk_branch")
            if name in results]
    for got in done[1:]:
        if not all(torch.equal(x, y) for x, y in zip(got, done[0])):
            raise RuntimeError("lift arms disagree")
    return out


def transform_n32768(gen: torch.Generator, name: str) -> float | None:
    """Device ms of ntt_forward or ntt_inverse on the JAX bench's g_n32768
    shape [3,1,32768], or None where this tree raises there."""
    ps = primes.find_ntt_primes(32768, 3)
    tb = ntt.build_tables(32768, ps, "cuda")
    x = residues(gen, ps, 1, 32768)
    fn = lambda: getattr(ntt_cuda, name)(x, tb)
    try:
        fn()
    except (ValueError, RuntimeError) as err:
        print(f"torch_ab: {name} at n=32768 raised: {err}", file=sys.stderr)
        return None
    return device_ms(fn)


def key_down_switch_k8() -> float:
    """device_ms of switch_relin_keys to level 4 at the k8 configuration
    (n = 8192, log_q = 218, k = 8, ks_omega = 1): an inverse transform of
    the [8, 8, n] key rows, four roundings and a forward transform."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        prm = make_scheme_params(SecurityParams(poly_degree=N, log_q=218, hamming_weight=H))
    fhe = FHE(prm, seed=11, device="cuda")
    _, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    return device_ms(lambda: bfv.switch_relin_keys(fhe.ctx, rlk, 4))


def keyswitch_inputs(gen: torch.Generator, qs, kd: int, batch: int, n: int,
                     prereduced: bool):
    """Keys in the stored [kd, k, 2, n] layout, read through the prime-major
    view, and the digits: d [kd, B, n] (digit j mod q_j), or [k, kd, B, n]."""
    keys_t = torch.stack([residues(gen, qs, 2, n) for _ in range(kd)]).permute(1, 0, 2, 3)
    if prereduced:
        return residues(gen, qs, kd * batch, n).view(len(qs), kd, batch, n), keys_t
    return torch.stack([residues(gen, (q,), batch, n)[0] for q in qs[:kd]]), keys_t


def galois_lanes(gen: torch.Generator) -> dict:
    """The automorphisms with the key switch around them, at the rotations'
    shapes (n = 8192, k = 3, kd = 3; a sum_slots stage also at k8_omega's
    k = 8, kd = 4), on random residues: in a tree with the Galois lanes one
    launch each, in a tree without them the parent's kernels for the same
    result (B16 + B7 + add_mod + cat; B17 + B14; B18 + B14); a sum_slots
    stage (B17 + B15) and B17 / B18 without elements in every tree.
    Each: device ms, and the chain's device kernels per call and span from
    a torch.profiler trace (trace)."""
    lanes = hasattr(ntt_cuda.ks_inner_batch, "galois_launches")
    ctx = quiet_context(N, LOG_Q, H)
    tb, qs, k = ctx.ntt_q, ctx.ntt_q.primes, ctx.k
    p3 = tb.p.view(-1, 1, 1)
    hoist = tuple(pow(3, s, 2 * N) for s in range(1, 9))
    keys_t = torch.stack([residues(gen, qs, 2) for _ in qs]).permute(1, 0, 2, 3)
    calls = {}
    for batch in (1, BATCH):
        d = torch.stack([residues(gen, (q,), batch)[0] for q in qs])       # [kd, B, n]
        ct = residues(gen, qs, 2 * batch).view(k, batch, 2, N).transpose(0, 1).contiguous()
        view = ct.permute(1, 2, 0, 3)                                      # [k, 2, B, n]
        if lanes:
            fn = (lambda d=d, v=view: ntt_cuda.keyswitch_fused_batch(d, keys_t, tb, g=3,
                                                                     c0=v[:, 0]))
        else:
            def fn(d=d, v=view, b=batch):
                rot = galois_cuda.automorphism_fused(v, (pow(3, -1, 2 * N),) * b, tb.p)
                delta = ntt_cuda.keyswitch_fused_batch(d, keys_t, tb)
                return torch.stack([modmath.add_mod(rot[:, 0], delta[:, 0], p3),
                                    delta[:, 1]], dim=1)
        calls[f"rotation_B{batch}"] = fn
    keys_e = residues(gen, qs, 3 * BATCH * 2).view(3, 3, BATCH, 2, N)
    hs8 = tuple(pow(g, -1, 2 * N) for g in hoist)
    dg1, c01 = residues(gen, qs, 3).view(3, 3, 1, N), residues(gen, qs, 1)[:, 0]
    dg4, c04 = residues(gen, qs, 3 * 4).view(3, 3, 4, N), residues(gen, qs, 4)
    if lanes:
        calls["hoisted_E8"] = lambda: ntt_cuda.ks_inner_batch(dg1, keys_e, tb, hoist, c01)
        calls["hoisted_grouped_C4_E8"] = lambda: ntt_cuda.ks_inner_grouped(
            dg4, keys_e, tb, hoist, c04)
    else:
        calls["hoisted_E8"] = lambda: galois_cuda.automorphism_fused(
            ntt_cuda.ks_inner_batch(dg1, keys_e, tb), hs8, tb.p, c01)
        calls["hoisted_grouped_C4_E8"] = lambda: galois_cuda.automorphism_fused(
            ntt_cuda.ks_inner_grouped(dg4, keys_e, tb), hs8 * 4, tb.p,
            c04.repeat_interleave(BATCH, dim=1))
    # B17 and B18 without elements, the plain inner product; and at a
    # sum_slots stage's E = 3, with and without the Galois lane
    calls["ks_inner_batch_E8"] = lambda: ntt_cuda.ks_inner_batch(dg1, keys_e, tb)
    keys_3 = keys_e[:, :, :3]
    calls["ks_inner_batch_E3"] = lambda: ntt_cuda.ks_inner_batch(dg1, keys_3, tb)
    calls["hoisted_E3"] = (lambda: ntt_cuda.ks_inner_batch(dg1, keys_3, tb, hoist[:3], c01)
                           if lanes else galois_cuda.automorphism_fused(
                               ntt_cuda.ks_inner_batch(dg1, keys_3, tb), hs8[:3], tb.p, c01))
    calls["ks_inner_grouped_C4_E8"] = lambda: ntt_cuda.ks_inner_grouped(dg4, keys_e, tb)
    ctx8 = quiet_context(N, 218, H)
    for label, t, kd in (("sum_E3", tb, 3), ("sum_E3_k8_omega", ctx8.ntt_q, 4)):
        kk = t.k
        dg = residues(gen, t.primes, kd).view(kk, kd, 1, N)
        keys = residues(gen, t.primes, kd * 3 * 2).view(kk, kd, 3, 2, N)
        c0, base = residues(gen, t.primes, 1)[:, 0], residues(gen, t.primes, 2)
        calls[label] = (lambda dg=dg, keys=keys, t=t, c0=c0, base=base:
                        galois_cuda.automorphism_fused_sum(
                            ntt_cuda.ks_inner_batch(dg, keys, t), hs8[:3], t.p, c0, base))
    out = {}
    for name, fn in calls.items():
        tr = trace(fn)
        out[name] = {"device_ms": device_ms(fn), "kernels_per_call": tr.get("kernels_per_call"),
                     "span_us": tr.get("span_us")}
    return out


def rotation_ops(fhe, sk, pk) -> tuple[dict, dict]:
    """The rotation ops of the headline configuration: rotate_rows by 1,
    rotate_columns, rotate_rows_batch by 1 at B = 8, the 8 hoisted steps
    and their batch of 4, sum_slots.  Returns the ops and the Galois keys'
    owner (to keep them alive)."""
    cts = fhe.encrypt_batch([fhe.encode([5 + i, 10, 15, 20]) for i in range(BATCH)], pk)
    a = cts[0]
    hoist = tuple(pow(3, s, 2 * N) for s in range(1, 9))
    gk = fhe.galoiskey_gen(sk, elements=hoist + (2 * N - 1,))
    gk_ss = fhe.galoiskey_gen(sk, elements=fhe.sum_slots_elements())
    steps = tuple(range(1, 9))
    ops = {"rotate_rows": lambda: fhe.rotate_rows(a, 1, gk),
           "rotate_columns": lambda: fhe.rotate_columns(a, gk),
           "rotate_rows_batch_B8": lambda: fhe.rotate_rows_batch(cts, 1, gk),
           "hoisted_8_steps": lambda: fhe.rotate_rows_hoisted(a, steps, gk),
           "hoisted_batch_C4": lambda: fhe.rotate_rows_hoisted_batch(cts[:4], steps, gk),
           "sum_slots": lambda: fhe.sum_slots(a, gk_ss)}
    return ops, (gk, gk_ss, cts)


def lanes_main(card: str) -> int:
    """--lanes: the rotation ops (device ms and traces) and galois_lanes
    only, for a design A/B across trees."""
    fhe = FHE(poly_degree=N, log_q=LOG_Q, hamming_weight=H, seed=3, device="cuda")
    pk, sk = fhe.keygen()
    ops, _keep = rotation_ops(fhe, sk, pk)
    out = {"card": card, "tree": str(TREE),
           "device_ms": {name: device_ms(fn) for name, fn in ops.items()},
           "traces": {name: trace(fn) for name, fn in ops.items()},
           "galois_lanes": galois_lanes(torch.Generator(device="cuda").manual_seed(5))}
    print(json.dumps(out))
    return 0


def context_build() -> dict:
    """--context-build, run by host_main in a fresh process: the seconds to
    load the native library (utils/native.py; with a make first where it is
    absent, unless the environment forbids it), and of make_scheme_params
    plus make_context on the card at the headline and g_bootstrap
    configurations, on whichever path the environment selects
    (FHE_TPU_NO_NATIVE=1: the Python bodies).  null where the tree has no
    native loader."""
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    try:
        from fhe_tpu_torch.utils import native
    except ImportError:
        native = None
    t0 = time.perf_counter()
    loaded = native is not None and native.available()
    out = {"native": loaded,
           "native_load_s": None if native is None else time.perf_counter() - t0}
    for label, kw in (("n8192_log_q90", dict(poly_degree=N, log_q=LOG_Q, hamming_weight=H)),
                      ("n1024_log_q120", dict(poly_degree=1024, log_q=120, lambda_=0,
                                              hamming_weight=16))):
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            make_context(make_scheme_params(SecurityParams(**kw)), device="cuda")
        torch.cuda.synchronize()
        out[f"{label}_s"] = time.perf_counter() - t0
    return out


def host_main(card: str) -> int:
    """--host: wall_ms (median of 50; host work included) and device_ms of
    the headline multiply, rotate_rows by 1 and sum_slots, which carry the
    facade's per-op timer where the tree has one; and, first, so that in a
    fresh checkout the native library's build falls in its load time,
    context_build in a fresh process with the environment as it is and,
    where the tree has a native loader, again with FHE_TPU_NO_NATIVE=1."""
    builds = {}
    for label, extra in (("default", {}), ("no_native", {"FHE_TPU_NO_NATIVE": "1"})):
        run = subprocess.run([sys.executable, str(Path(__file__).resolve()), str(TREE),
                              "--context-build"], env={**os.environ, **extra},
                             capture_output=True, text=True, timeout=600, check=True)
        builds[label] = json.loads(run.stdout.strip().splitlines()[-1])
        if builds[label]["native_load_s"] is None:
            break
    fhe = FHE(poly_degree=N, log_q=LOG_Q, hamming_weight=H, seed=3, device="cuda")
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    rot_ops, _keep = rotation_ops(fhe, sk, pk)
    a, b = _keep[2][0], _keep[2][1]
    ops = {"multiply": lambda: fhe.multiply(a, b, rlk),
           "rotate_rows": rot_ops["rotate_rows"], "sum_slots": rot_ops["sum_slots"]}
    out = {"card": card, "tree": str(TREE),
           "wall_ms": {name: wall_ms(fn, reps=50) for name, fn in ops.items()},
           "device_ms": {name: device_ms(fn) for name, fn in ops.items()},
           "context_build": builds}
    print(json.dumps(out))
    return 0


def mxu_main(card: str) -> int:
    """--mxu: the engine's forward at B = 1 and 64 and FHE(use_mxu=True)'s
    multiply (BFV and BGV) beside ntt_forward and the default multiply, all
    from this one process; the engine's entries are None for a tree that
    lacks ops/ntt_mxu.py."""
    try:
        from fhe_tpu_torch.ops import ntt_mxu
    except ImportError:
        ntt_mxu = None
    gen = torch.Generator(device="cuda").manual_seed(17)
    out = {"card": card, "tree": str(TREE)}
    for scheme, seed in (("bfv", 3), ("bgv", 1)):
        fhe = FHE(poly_degree=N, log_q=LOG_Q, hamming_weight=H, seed=seed, scheme=scheme,
                  device="cuda")
        pk, sk = fhe.keygen()
        rlk = fhe.relinkey_gen(sk)
        a, b = (fhe.encrypt(fhe.encode(v), pk) for v in ([5, 10, 15, 20], [3, 6, 9, 12]))
        x1, x64 = residues(gen, fhe.params.q_primes, 1), residues(gen, fhe.params.q_primes, 64)
        mul = lambda f: (lambda: f.multiply(a, b, rlk))
        entry = {"multiply_relin_ms": device_ms(mul(fhe)),
                 "multiply_relin_wall_ms": wall_ms(mul(fhe)), "trace_multiply": trace(mul(fhe))}
        if scheme == "bfv":
            tb = fhe.ctx.ntt_q
            entry["forward_ntt_ms"] = device_ms(lambda: ntt_cuda.ntt_forward(x1, tb))
            entry["forward_ntt_ms_batched"] = device_ms(
                lambda: ntt_cuda.ntt_forward(x64, tb)) / 64
        engine = None
        if ntt_mxu is not None:
            fm = FHE(fhe.params, seed=seed, scheme=scheme, device="cuda", use_mxu=True)
            if not torch.equal(fm.multiply(a, b, rlk).data, fhe.multiply(a, b, rlk).data):
                raise RuntimeError(f"{scheme}: the engine's multiply differs from the default")
            engine = {"multiply_relin_ms_mxu_engine": device_ms(mul(fm)),
                      "multiply_relin_wall_ms_mxu_engine": wall_ms(mul(fm)),
                      "trace_multiply_mxu_engine": trace(mul(fm))}
            if scheme == "bfv":
                tbm = fm.ctx.ntt_q_mxu
                engine["forward_ntt_mxu_ms"] = device_ms(lambda: ntt_mxu.ntt_forward(x1, tbm))
                engine["forward_ntt_mxu_ms_batched"] = device_ms(
                    lambda: ntt_mxu.ntt_forward(x64, tbm)) / 64
                engine["trace_forward_ntt_mxu"] = trace(lambda: ntt_mxu.ntt_forward(x1, tbm))
        out[scheme] = {**entry, "engine": engine}
    print(json.dumps(out))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    if CONTEXT_BUILD:
        print(json.dumps(context_build()))
        return 0
    if HOST_ONLY:
        return host_main(card)
    if LANES_ONLY:
        return lanes_main(card)
    if MXU_ONLY:
        return mxu_main(card)
    if BOOTSTRAP_ONLY:
        print(json.dumps({"card": card, "tree": str(TREE), "bootstrap": bootstrap_ops()}))
        return 0
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
    pt = fhe.encode([5, 10, 15, 20])
    pts = [fhe.encode([5 + i, 10]) for i in range(BATCH)]
    hoist = tuple(pow(3, s, 2 * N) for s in range(1, 9))
    gk = fhe.galoiskey_gen(sk, elements=hoist + (2 * N - 1,))
    gk_ss = fhe.galoiskey_gen(sk, elements=fhe.sum_slots_elements())
    a_ntt = fhe.to_ntt(a)
    steps = tuple(range(1, 9))
    ops = {"keygen": fhe.keygen,
           "multiply_no_relin": lambda: fhe.multiply_no_relin(a, b),
           "relinearize": lambda: fhe.relinearize(m3, rlk),
           "multiply": lambda: fhe.multiply(a, b, rlk),
           "decrypt_after_multiply": lambda: fhe.decrypt(prod, sk),
           "encrypt": lambda: fhe.encrypt(pt, pk),
           "encrypt_batch_B8": lambda: fhe.encrypt_batch(pts, pk),
           "decrypt_batch_B8": lambda: fhe.decrypt_batch(cts_a, sk),
           "multiply_batch_B8": lambda: fhe.multiply_batch(cts_a, cts_b, rlk),
           "encode": lambda: fhe.encode([5, 10, 15, 20]),
           "to_coeff": lambda: fhe.to_coeff(a_ntt),
           "rotate_rows": lambda: fhe.rotate_rows(a, 1, gk),
           "rotate_rows_ntt_form": lambda: fhe.rotate_rows(a_ntt, 1, gk),
           "galoiskey_gen_1": lambda: fhe.galoiskey_gen(sk, elements=(3,)),
           "hoisted_8_steps": lambda: fhe.rotate_rows_hoisted(a, steps, gk),
           "hoisted_batch_C4": lambda: fhe.rotate_rows_hoisted_batch(cts_a[:4], steps, gk),
           "sum_slots": lambda: fhe.sum_slots(a, gk_ss)}
    out = {"card": card, "tree": str(TREE), "device_ms": {}, "wall_ms": {}}
    for name, fn in ops.items():
        out["device_ms"][name] = device_ms(fn)
        out["wall_ms"][name] = wall_ms(fn)
    for what in ("device_ms", "wall_ms"):
        for name in ("encrypt_batch_B8", "decrypt_batch_B8", "multiply_batch_B8"):
            out[what][name + "_per_ct"] = out[what][name] / BATCH
    out["multiply_batch_B8_trace"] = trace(ops["multiply_batch_B8"])
    out["multiply_trace"] = trace(ops["multiply"])
    rot_ops, _keep = rotation_ops(fhe, sk, pk)
    for name in ("rotate_columns", "rotate_rows_batch_B8"):
        out["device_ms"][name] = device_ms(rot_ops[name])
        out["wall_ms"][name] = wall_ms(rot_ops[name])
    out["rotation_traces"] = {name: trace(fn) for name, fn in rot_ops.items()}
    ctx = fhe.ctx
    gen = torch.Generator(device="cuda").manual_seed(7)
    qs, (tq, tbsk) = ctx.ntt_q.primes, ctx.mul_tables
    ab, tx_q = residues(gen, qs, 4), residues(gen, qs, 3)
    ab_b = residues(gen, qs, 4 * BATCH).view(3, BATCH, 4, N).transpose(0, 1)
    ab_b = ab_b.contiguous().permute(1, 2, 0, 3)
    tx_b = residues(gen, qs, 3 * BATCH).view(3, 3, BATCH, N)
    ct = residues(gen, qs, 2)
    s = residues(gen, qs, 1)
    c0, c1 = residues(gen, qs, BATCH), residues(gen, qs, BATCH)
    dc = rns.make_decrypt(qs, fhe.params.t, fhe.params.gamma, "cuda")
    u, u_b = residues(gen, qs, 1), residues(gen, qs, BATCH)
    x, y = residues(gen, qs, 2), residues(gen, qs, 2)
    kernels = {
        "mul_by_ntt_operand": lambda: ntt_cuda.mul_by_ntt_operand(u, pk.data, ctx.ntt_q),
        "mul_by_ntt_operand_batch_B8": lambda: ntt_cuda.mul_by_ntt_operand_batch(
            u_b, pk.data, ctx.ntt_q),
        "tensor_product": lambda: ntt_cuda.tensor_product(x, y, tq),
        "tensor_product_batch_B8": lambda: ntt_cuda.tensor_product_batch(
            ab_b[:, :2], ab_b[:, 2:], tq),
        "bsk_branch_fused": lambda: rns_cuda.bsk_branch_fused(
            ab, tx_q, ctx.smq, ctx.floor_c, tbsk),
        "bsk_branch_fused_batch_B8": lambda: rns_cuda.bsk_branch_fused_batch(
            ab_b, tx_b, ctx.smq, ctx.floor_c, tbsk),
        "decrypt_fused": lambda: decrypt_cuda.decrypt_fused(
            ct[:, 0:1], ct[:, 1:2], s, ctx.ntt_q, dc),
        "decrypt_fused_B8": lambda: decrypt_cuda.decrypt_fused(c0, c1, s, ctx.ntt_q, dc)}
    ctx8 = quiet_context(N, 218, H)
    qs8, tbsk8 = ctx8.ntt_q.primes, ctx8.mul_tables[1]
    ab8, tx8 = residues(gen, qs8, 4), residues(gen, qs8, 3)
    kernels["bsk_branch_fused_k8"] = lambda: rns_cuda.bsk_branch_fused(
        ab8, tx8, ctx8.smq, ctx8.floor_c, tbsk8)
    tb = ctx.ntt_q
    x1, x3, x16 = residues(gen, qs, 1), residues(gen, qs, 3), residues(gen, qs, 16)
    kernels["ntt_forward"] = lambda: ntt_cuda.ntt_forward(x1, tb)
    kernels["ntt_forward_keygen_B3"] = lambda: ntt_cuda.ntt_forward(x3, tb)
    kernels["ntt_forward_B16"] = lambda: ntt_cuda.ntt_forward(x16, tb)
    kernels["ntt_inverse"] = lambda: ntt_cuda.ntt_inverse(x1, tb)
    kernels["ntt_inverse_B16"] = lambda: ntt_cuda.ntt_inverse(x16, tb)
    tt = ntt.build_tables(N, (fhe.params.t,), "cuda")
    xt = residues(gen, (fhe.params.t,), 1)
    kernels["ntt_inverse_t_encode"] = lambda: ntt_cuda.ntt_inverse(xt, tt)
    # each key-switch case: (name, tables, kd, batch (None: the single
    # function), prereduced)
    ctx16 = quiet_context(16384, LOG_Q, H)
    ctx_s = quiet_context(256, 150, 32)
    tb8 = ctx8.ntt_q
    for name, tks, kd, batch, prereduced in (
            ("keyswitch_fused", tb, 3, None, False),
            ("keyswitch_fused_batch_B8", tb, 3, BATCH, False),
            ("keyswitch_fused_k8_kd8", tb8, 8, None, False),
            ("keyswitch_fused_prereduced_k8", tb8, 4, None, True),
            ("keyswitch_fused_batch_prereduced_k8_B8", tb8, 4, BATCH, True),
            ("keyswitch_fused_n16384", ctx16.ntt_q, 3, None, False),
            ("keyswitch_fused_n256", ctx_s.ntt_q, 5, None, False)):
        d, keys_t = keyswitch_inputs(gen, tks.primes, kd, batch or 1, tks.n, prereduced)
        if batch is None:
            kernels[name] = (lambda d=d[..., 0, :], k=keys_t, t=tks, pr=prereduced:
                             ntt_cuda.keyswitch_fused(d, k, t, pr))
        else:
            kernels[name] = (lambda d=d, k=keys_t, t=tks, pr=prereduced:
                             ntt_cuda.keyswitch_fused_batch(d, k, t, pr))
    dg = residues(gen, qs, 3).view(3, 3, 1, N)
    keys_e = residues(gen, qs, 3 * BATCH * 2).view(3, 3, BATCH, 2, N)
    kernels["ks_inner_batch"] = lambda: ntt_cuda.ks_inner_batch(dg, keys_e, tb)
    dg_c = residues(gen, qs, 3 * 4).view(3, 3, 4, N)
    kernels["ks_inner_grouped_C4_E8"] = lambda: ntt_cuda.ks_inner_grouped(dg_c, keys_e, tb)
    tq_s, tbsk_s = ntt.slice_tables(ctx_s.ntt_q, ctx_s.k - 1), ctx_s.mul_levels[1][1]
    u_s, w_s = residues(gen, tq_s.primes, 1, 256), residues(gen, tq_s.primes, 2, 256)
    lift_s = residues(gen, tbsk_s.primes, 4, 256)
    kernels["mul_by_ntt_operand_n256"] = lambda: ntt_cuda.mul_by_ntt_operand(u_s, w_s, tq_s)
    kernels["tensor_product_n256_bsk"] = lambda: ntt_cuda.tensor_product(
        lift_s[:, :2], lift_s[:, 2:], tbsk_s)
    out["kernel_device_ms"] = {name: device_ms(fn) for name, fn in kernels.items()}
    out["kernel_device_ms"]["ntt_forward_n32768"] = transform_n32768(gen, "ntt_forward")
    out["kernel_device_ms"]["ntt_inverse_n32768"] = transform_n32768(gen, "ntt_inverse")
    out["device_ms"]["key_down_switch_k8_level4"] = key_down_switch_k8()
    out["small_device_ms"] = small_multiply()
    out["lift_arms"] = lift_arms(gen)
    out["multiply_k8"] = multiply_k8(1)
    out["multiply_k8_omega"] = multiply_k8(2)
    out["conv_kernels"] = conv_kernels(gen)
    out["galois_lanes"] = galois_lanes(gen)
    out["multiply_relin_ms_n16384"] = multiply_n16384(1)
    out["multiply_relin_ms_n16384_omega2"] = multiply_n16384(2)
    out["multiply_relin_ms_n32768"] = multiply_large()
    out["multiply_relin_ms_secure128_n32768"] = multiply_large(870)
    out["multiply_relin_ms_n65536"] = multiply_large(LOG_Q, 65536)
    out["bgv"] = bgv_ops()
    out["bootstrap"] = bootstrap_ops()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
