"""NTT-friendly prime generation and number-theory host utilities.

Counterpart of ``fhe_tpu/primes.py`` (pure-Python path only).  Everything here
is exact host arithmetic that runs once when a context is built; the device
only ever sees the tables derived from it.
"""

from __future__ import annotations

import functools

# Deterministic Miller-Rabin witness set: correct for all n < 3.3 * 10^24.
_MR_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin primality test."""
    if n < 2:
        return False
    for p in _MR_WITNESSES:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_WITNESSES:
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def find_ntt_primes(n: int, count: int, bits: int = 30,
                    exclude: tuple[int, ...] = ()) -> list[int]:
    """``count`` primes p ≡ 1 (mod 2n), descending from 2**bits, all inside
    (2**(bits-1), 2**bits)."""
    two_n = 2 * n
    p = (1 << bits) - 1
    p -= (p - 1) % two_n
    out: list[int] = []
    lo = 1 << (bits - 1)
    while len(out) < count:
        if p <= lo:
            raise ValueError(
                f"not enough {bits}-bit NTT primes for n={n}, count={count}")
        if p not in exclude and is_prime(p):
            out.append(p)
        p -= two_n
    return out


@functools.lru_cache(maxsize=None)
def _factorize(n: int) -> tuple[int, ...]:
    """Unique prime factors of n by trial division."""
    fs = []
    d = 2
    while d * d <= n:
        if n % d == 0:
            fs.append(d)
            while n % d == 0:
                n //= d
        d += 1 if d == 2 else 2
    if n > 1:
        fs.append(n)
    return tuple(fs)


def primitive_root(p: int) -> int:
    """Smallest generator of (Z/p)^*."""
    if p == 2:
        return 1
    phi = p - 1
    factors = _factorize(phi)
    g = 2
    while True:
        if all(pow(g, phi // f, p) != 1 for f in factors):
            return g
        g += 1


def root_of_unity(order: int, p: int) -> int:
    """A primitive ``order``-th root of unity mod p (requires order | p-1)."""
    if (p - 1) % order != 0:
        raise ValueError(f"{order} does not divide p-1 for p={p}")
    w = pow(primitive_root(p), (p - 1) // order, p)
    if pow(w, order, p) != 1 or pow(w, order // 2, p) == 1:
        raise ArithmeticError(f"no primitive {order}-th root found mod {p}")
    return w


def negacyclic_psi(n: int, p: int) -> int:
    """Primitive 2n-th root of unity ψ mod p (ψ^n ≡ -1), for X^n + 1."""
    return root_of_unity(2 * n, p)


def mod_inverse(a: int, p: int) -> int:
    return pow(a, -1, p)


def bit_reverse(x: int, bits: int) -> int:
    """Reverse the low ``bits`` bits of x."""
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r
