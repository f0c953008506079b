"""The benchmark's plain reference: what a BFV ciphertext decrypts to, and
how much noise it carries, worked out from the secret the benchmark made.

NumPy, Python integers and plain PyTorch only; nothing here imports the
program under test or reads a table it built.  The primes, the root of
unity and the slot order are derived again from the scheme's published
conventions:

* the q primes are the k largest primes p = 1 (mod 2n) below 2^30, other
  than t (``ntt_primes``);
* slot j of row 0 holds the plaintext polynomial's value at psi^(3^j), slot
  j of row 1 its value at psi^(-3^j), psi = g^((t-1)/2n) for g the smallest
  generator of (Z/t)^* (``slots``).

Decryption is exact: the phase c0 + c1*s mod every q_i (the secret is
ternary with few nonzero coefficients, so c1*s is a signed sum of
negacyclic shifts), then the CRT lift to Z_Q in Python integers and
m = round(t*x/Q).  The noise of a coefficient is v = t*x - Q*m, the centred
residue of t*x mod Q; decryption is right while |v| < Q/2.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MR_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin, exact below 3.3e24."""
    if n < 2:
        return False
    for p in _MR_WITNESSES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_WITNESSES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def ntt_primes(n: int, count: int, exclude: tuple[int, ...] = (), bits: int = 30) -> list[int]:
    """The ``count`` largest primes p = 1 (mod 2n) below 2^bits, skipping
    ``exclude``."""
    p = (1 << bits) - 1
    p -= (p - 1) % (2 * n)
    out = []
    while len(out) < count:
        if p <= 1 << (bits - 1):
            raise ValueError(f"fewer than {count} {bits}-bit primes = 1 mod {2 * n}")
        if p not in exclude and is_prime(p):
            out.append(p)
        p -= 2 * n
    return out


def _prime_factors(n: int) -> list[int]:
    out, d = [], 2
    while d * d <= n:
        if n % d == 0:
            out.append(d)
            while n % d == 0:
                n //= d
        d += 1
    return out + ([n] if n > 1 else [])


def negacyclic_root(n: int, t: int) -> int:
    """psi = g^((t-1)/2n), g the smallest generator mod t."""
    factors = _prime_factors(t - 1)
    g = 2
    while any(pow(g, (t - 1) // f, t) == 1 for f in factors):
        g += 1
    return pow(g, (t - 1) // (2 * n), t)


def _evaluations(coeffs: np.ndarray, t: int) -> np.ndarray:
    """[..., n] polynomials mod t -> their values at psi^(2i+1), i < n: the
    twist by psi^j, then a radix-2 cyclic transform with root psi^2."""
    n = coeffs.shape[-1]
    psi = negacyclic_root(n, t)
    pows = np.empty(n, dtype=np.int64)
    x = 1
    for j in range(n):
        pows[j] = x
        x = x * psi % t
    a = coeffs.astype(np.int64) % t * pows % t
    bits = n.bit_length() - 1
    rev = np.array([int(format(i, f"0{bits}b")[::-1], 2) if bits else 0 for i in range(n)])
    a = a[..., rev]
    w = psi * psi % t
    size = 2
    while size <= n:
        half = size // 2
        w_len = pow(w, n // size, t)
        tw = np.empty(half, dtype=np.int64)
        x = 1
        for j in range(half):
            tw[j] = x
            x = x * w_len % t
        blocks = a.reshape(*a.shape[:-1], n // size, size)
        u = blocks[..., :half]
        v = blocks[..., half:] * tw % t
        a = np.concatenate([(u + v) % t, (u - v) % t], axis=-1).reshape(a.shape)
        size *= 2
    return a


def slot_positions(n: int) -> np.ndarray:
    """For slot s (row 0 then row 1), the index i of its evaluation point
    psi^(2i+1): row 0 slot j at psi^(3^j), row 1 slot j at psi^(-3^j)."""
    m = 2 * n
    g, row0, row1 = 1, [], []
    for _ in range(n // 2):
        row0.append((g - 1) // 2)
        row1.append((m - g - 1) // 2)
        g = g * 3 % m
    return np.array(row0 + row1, dtype=np.int64)


def slots(coeffs: np.ndarray, t: int) -> np.ndarray:
    """The n slot values of [..., n] plaintext polynomials mod t."""
    return _evaluations(coeffs, t)[..., slot_positions(coeffs.shape[-1])]


def phase(ct: torch.Tensor, s_pos: torch.Tensor, s_sign: torch.Tensor,
          primes: list[int]) -> torch.Tensor:
    """c0 + c1*s mod each q_i for a [k, 2, n] residue tensor, s the ternary
    secret given by its nonzero positions and signs; int64 [k, n]."""
    c = ct.to(torch.int64)
    q = torch.tensor(primes, dtype=torch.int64, device=c.device).view(-1, 1)
    c1 = c[:, 1]
    acc = c[:, 0].clone()
    for j, sign in zip(s_pos.tolist(), s_sign.tolist()):
        shifted = torch.roll(c1, j, dims=-1)
        shifted[:, :j] = -shifted[:, :j]                  # x^n = -1
        acc += sign * shifted
    return torch.remainder(acc, q)


def decrypt_exact(x: np.ndarray, primes: list[int], t: int) -> tuple[np.ndarray, int]:
    """Phase residues [k, n] -> (m [n] mod t, max |v| over the coefficients),
    m = round(t*x/Q) and v = t*x - Q*m, in Python integers."""
    big_q = math.prod(primes)
    phat = [big_q // p for p in primes]
    inv = np.array([pow(ph % p, -1, p) for ph, p in zip(phat, primes)], dtype=np.int64)
    qs = np.array(primes, dtype=np.int64)
    y = x.astype(np.int64) % qs[:, None] * inv[:, None] % qs[:, None]
    lifted = y.T.astype(object).dot(np.array(phat, dtype=object)) % big_q
    scaled = lifted * t
    m = (scaled + big_q // 2) // big_q
    v = scaled - m * big_q
    m_t = np.array([int(e) % t for e in m], dtype=np.int64)
    return m_t, int(max(abs(int(e)) for e in v))


def judge(ct: np.ndarray, expected_slots: np.ndarray, s_pos: torch.Tensor,
          s_sign: torch.Tensor, primes: list[int], t: int, device) -> tuple[int, float]:
    """(slots that differ from ``expected_slots``, the largest |v| / t) of
    one [k, 2, n] output ciphertext."""
    x = phase(torch.from_numpy(ct).to(device), s_pos.to(device), s_sign.to(device), primes)
    m, v_max = decrypt_exact(x.cpu().numpy(), primes, t)
    wrong = int(np.count_nonzero(slots(m, t) != expected_slots % t))
    return wrong, v_max / t
