#!/usr/bin/env python3
"""Randomized-circuit fuzzer of the PyTorch port (fhe_tpu_torch).

For a seed it draws the same circuit as ``scripts/fuzz.py`` (the same
``np.random.default_rng(seed)`` calls in the same order: scheme, n, log_q,
Hamming weight, t, ks_omega, plaintext values, ops, rotation steps, the
hoisted / plain and cached-operand choices), runs it through the port's
``FHE`` while it tracks the plaintext slot model, and judges it as
``fuzz.py`` does: the exact noise budget against the model's plaintext, the
tracked budget, then the decoded slots.  One line per circuit:

    python scripts/fuzz_torch.py --iterations 24 --start-seed 1000
    python scripts/fuzz_torch.py --iterations 8 --device cpu

The circuit's execution (``execute``) is apart from its data: keys and an
``encrypt`` callback come from the caller, so ``replay`` can run a recorded
circuit again on other devices from the same keys and fresh ciphertexts.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from fhe_tpu_torch import FHE
from fhe_tpu_torch.params import SchemeParams, SecurityParams, make_scheme_params

OPS = ["add", "sub", "mul", "add_plain", "sub_plain", "mul_plain",
       "rot_rows", "rot_cols", "mod_switch", "toggle_domain"]


@dataclasses.dataclass
class Draw:
    """A circuit's parameters and the generator that draws the rest of it."""

    seed: int
    rng: np.random.Generator
    scheme: str
    params: SchemeParams
    log_q: int


@dataclasses.dataclass
class Run:
    """What ``execute`` leaves: the final ciphertext, the slot model, the ops
    that ran, and the fresh ciphertexts ``encrypt`` handed in, in order."""

    ct: object
    model: np.ndarray
    ops: list
    fresh: list


def draw(seed: int) -> Draw:
    """The parameter draws of ``fuzz.py``'s ``run_circuit``, in its order."""
    rng = np.random.default_rng(seed)
    scheme = str(rng.choice(["bfv", "bgv"]))
    n = int(rng.choice([128, 256, 512]))
    log_q = int(rng.choice([120, 150, 180]))
    hw = int(rng.choice([8, 16, 32]))
    # 65537 (Fermat), 114689 = 7*2^14+1 and 786433 = 3*2^18+1
    t = int(rng.choice([65537, 65537, 114689, 786433]))
    omega = int(rng.choice([1, 1, 2]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # these n are below 128-bit security
        params = make_scheme_params(SecurityParams(
            poly_degree=n, log_q=log_q, hamming_weight=hw, plain_modulus=t,
            ks_omega=omega))
    return Draw(seed, rng, scheme, params, log_q)


def make_fhe(d: Draw, device) -> FHE:
    return FHE(d.params, seed=d.seed, scheme=d.scheme, device=device)


def execute(fhe: FHE, d: Draw, gal, rlk, encrypt) -> Run:
    """Run the rest of d's circuit: ``encrypt(values)`` returns a fresh
    ciphertext of the drawn slot values (the caller's keys), ``rlk`` and
    ``gal`` are the relinearization and Galois keys.  Ops the library
    refuses with a ValueError are skipped, as in ``fuzz.py``."""
    rng, scheme, params = d.rng, d.scheme, d.params
    t, half = params.t, params.slot_count
    fresh_cts = []

    def fresh():
        v = rng.integers(0, t, size=2 * half).astype(np.int64)
        ct = encrypt(v)
        fresh_cts.append(ct)
        return ct, v

    def rot_model(vec, steps):
        return np.concatenate([np.roll(vec[:half], -steps), np.roll(vec[half:], -steps)])

    ct, model = fresh()
    mults = 0
    # each multiply consumes about log2(n) + log2(t) + slack bits of budget
    max_mults = max(1, (d.log_q - 60) // (26 + t.bit_length()))
    ops = []
    for _ in range(int(rng.integers(4, 12))):
        op = str(rng.choice(OPS))
        try:
            if op in ("add", "sub"):
                other, ov = fresh()
                other = fhe.mod_switch_to_level(other, ct.level)
                if scheme == "bgv" and other.scale_t != ct.scale_t:
                    continue
                if ct.is_ntt_form:
                    other = fhe.to_ntt(other)
                ct = fhe.add(ct, other) if op == "add" else fhe.sub(ct, other)
                model = (model + ov) % t if op == "add" else (model - ov) % t
            elif op == "mul":
                if mults >= max_mults:
                    continue
                other, ov = fresh()
                other = fhe.mod_switch_to_level(other, ct.level)
                if scheme == "bgv" and other.scale_t != ct.scale_t:
                    continue
                ct = fhe.multiply(ct, other, rlk)
                model = (model * ov) % t
                mults += 1
            elif op in ("add_plain", "sub_plain", "mul_plain"):
                pv = rng.integers(0, 30 if op == "mul_plain" else t,
                                  size=2 * half).astype(np.int64)
                pt = fhe.encode(pv)
                if op == "add_plain":
                    ct = fhe.add_plain(ct, pt)
                    model = (model + pv) % t
                elif op == "sub_plain":
                    ct = fhe.sub_plain(ct, pt)
                    model = (model - pv) % t
                else:
                    ct = fhe.multiply_plain(ct, pt, cache_operand=bool(rng.integers(0, 2)))
                    model = (model * pv) % t
            elif op == "rot_rows":
                steps = int(rng.integers(1, half))
                if rng.integers(0, 2) and steps in (1, 2, 4):
                    # the hoisted path (the default keys hold power-of-two steps)
                    ct = fhe.rotate_rows_hoisted(ct, [steps], gal)[0]
                else:
                    ct = fhe.rotate_rows(ct, steps, gal)
                model = rot_model(model, steps)
            elif op == "rot_cols":
                ct = fhe.rotate_columns(ct, gal)
                model = np.concatenate([model[half:], model[:half]])
            elif op == "mod_switch":
                if ct.level >= params.k - 1:
                    continue
                ct = fhe.mod_switch_to_next(ct)
            elif op == "toggle_domain":
                ct = fhe.to_coeff(ct) if ct.is_ntt_form else fhe.to_ntt(ct)
            ops.append(op)
        except ValueError:
            continue      # a scale or level guard firing is fine
    return Run(ct, model, ops, fresh_cts)


def describe(d: Draw, run: Run) -> str:
    p = d.params
    return (f"seed={d.seed} {d.scheme} n={p.n} logq={d.log_q} t={p.t} "
            f"omega={p.security.ks_omega} ops={run.ops}")


def judge(fhe: FHE, run: Run, sk) -> tuple[bool, str]:
    """``fuzz.py``'s verdict: the exact budget against the model's plaintext
    (negative past exhaustion), then the tracked budget and the slots."""
    budget = fhe.exact_noise_budget(run.ct, sk, fhe.encode(run.model))
    tracked = float(run.ct.noise_budget)
    desc = f" budget={budget:.2f} tracked={tracked:.2f}"
    if budget <= 0.0 or (budget < 1.0 and tracked <= 0.0):
        # exhausted: the tracked budget must have said so (a true noise past
        # q/2 wraps mod q and can read back as a small positive budget)
        if tracked > 4.0:
            return False, desc + " EXHAUSTED but tracked budget still high"
        return True, desc + " [noise exhausted — flagged by library]"
    got = fhe.decode(fhe.decrypt(run.ct, sk)).astype(np.int64)
    if not np.array_equal(got, run.model):
        bad = np.nonzero(got != run.model)[0][:5]
        return False, desc + f" MISMATCH at slots {bad.tolist()}"
    return True, desc


@dataclasses.dataclass
class Record:
    """A circuit's keys (pk, sk, rlk, gal) and its run."""

    keys: tuple
    run: Run


def run_circuit(seed: int, device="cuda") -> tuple[bool, str, Record]:
    """Draw, key and run circuit ``seed`` on ``device``, then judge it."""
    d = draw(seed)
    fhe = make_fhe(d, device)
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    gal = fhe.galoiskey_gen(sk)
    run = execute(fhe, d, gal, rlk, lambda v: fhe.encrypt(fhe.encode(v), pk))
    ok, verdict = judge(fhe, run, sk)
    return ok, describe(d, run) + verdict, Record((pk, sk, rlk, gal), run)


def moved(obj, device):
    """A key, ciphertext or tuple of them with every tensor on ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, (tuple, list)):
        return type(obj)(moved(x, device) for x in obj)
    if isinstance(obj, dict):
        return {k: moved(v, device) for k, v in obj.items()}
    return dataclasses.replace(obj, **{f.name: moved(getattr(obj, f.name), device)
                                       for f in dataclasses.fields(obj)
                                       if isinstance(getattr(obj, f.name),
                                                     (torch.Tensor, dict))})


def replay(seed: int, record: Record, device="cpu") -> Run:
    """Circuit ``seed`` again on ``device``, from the record's keys and its
    fresh ciphertexts (moved there) in the order the run drew them."""
    d = draw(seed)
    fhe = make_fhe(d, device)
    _, _, rlk, gal = moved(record.keys, device)
    queue = iter(record.run.fresh)
    return execute(fhe, d, gal, rlk, lambda v: moved(next(queue), device))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iterations", type=int, default=30)
    ap.add_argument("--start-seed", type=int, default=1000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    failures = 0
    t0 = time.time()
    for seed in range(args.start_seed, args.start_seed + args.iterations):
        ok, desc, _ = run_circuit(seed, args.device)
        print(("PASS " if ok else "FAIL ") + desc, flush=True)
        failures += not ok
    print(f"\n{args.iterations - failures}/{args.iterations} circuits OK "
          f"in {time.time() - t0:.0f}s")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
