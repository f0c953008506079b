"""Scheme parameterization (counterpart of ``fhe_tpu/params.py``).

Basis layout (BEHZ-style RNS-BFV):
  * q-basis   : k primes of 30 bits, p ≡ 1 (mod 2n)        (ciphertext modulus)
  * aux-basis : more 30-bit NTT primes B                   (tensor-product headroom)
  * m_sk      : one more 30-bit NTT prime                  (Shenoy-Kumaresan anchor)
  * m_tilde   : 2**16                                      (exact base-conversion fix)
  * gamma     : 30-bit prime                               (exact RNS decryption)

The plan is host-only Python ints, frozen and hashable, and chooses the same
primes as the JAX package for the same ``SecurityParams``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import warnings

from . import primes as _primes
from .utils.perf import PROCESS

PRIME_BITS = 30  # every RNS prime lives in (2**29, 2**30)
M_TILDE = 1 << 16


@dataclasses.dataclass(frozen=True)
class SecurityParams:
    lambda_: int = 128          # security level
    poly_degree: int = 4096     # n, power of two
    log_q: int = 120            # log2 of ciphertext modulus
    sigma: float = 3.2          # gaussian noise stddev
    hamming_weight: int = 64    # ternary secret-key weight
    # prime, t ≡ 1 (mod 2n), 65537 <= t < 2^29
    plain_modulus: int = 65537
    ks_omega: int = 1           # key-switch gadget rank (primes per digit)


@dataclasses.dataclass(frozen=True)
class SchemeParams:
    security: SecurityParams
    n: int
    t: int
    q_primes: tuple[int, ...]
    aux_primes: tuple[int, ...]
    m_sk: int
    gamma: int
    m_tilde: int = M_TILDE

    @property
    def q(self) -> int:
        return math.prod(self.q_primes)

    @property
    def delta(self) -> int:
        """Δ = floor(q/t)."""
        return self.q // self.t

    @property
    def k(self) -> int:
        return len(self.q_primes)

    @property
    def bsk_primes(self) -> tuple[int, ...]:
        return self.aux_primes + (self.m_sk,)

    @property
    def slot_count(self) -> int:
        return self.n // 2

    def modulus_chain(self) -> tuple[int, ...]:
        out = []
        q = 1
        for p in self.q_primes:
            q *= p
            out.append(q)
        return tuple(reversed(out))


# Maximum log2(q) for 128-bit classical security per polynomial degree
# (homomorphicencryption.org standard tables, ternary secret).
_MAX_LOGQ_128 = {1024: 27, 2048: 54, 4096: 109, 8192: 218, 16384: 438,
                 32768: 881}


def security_margin(security: SecurityParams) -> int | None:
    """Max-secure log q minus the realized modulus size (None off-table)."""
    cap = _MAX_LOGQ_128.get(security.poly_degree)
    if cap is None:
        return None
    k = max(2, math.ceil(security.log_q / PRIME_BITS))
    return cap - k * PRIME_BITS


@functools.lru_cache(maxsize=None)
def make_scheme_params(security: SecurityParams = SecurityParams()) -> SchemeParams:
    """Expand SecurityParams into a full plan: k = ceil(log_q / 30) q primes,
    the smallest aux base with B*m_sk > 4*t*n*q, then m_sk and gamma.  The
    process record (``utils.perf.PROCESS``) times the prime search as
    ``tables.primes``."""
    n = security.poly_degree
    if n & (n - 1) or n < 8:
        raise ValueError("poly_degree must be a power of two >= 8")
    margin = security_margin(security)
    if margin is not None and margin < 0 and security.lambda_ >= 128:
        k_req = max(2, math.ceil(security.log_q / PRIME_BITS))
        warnings.warn(
            f"parameters (n={n}, log_q={security.log_q} -> realized "
            f"~{k_req * PRIME_BITS} bits over {k_req} primes) fall below "
            f"the requested {security.lambda_}-bit security level (max "
            f"log_q for n={n} is {_MAX_LOGQ_128[n]})", stacklevel=2)
    t = security.plain_modulus
    if not (65537 <= t < (1 << 29)):
        raise ValueError(
            f"plain_modulus {t} out of range [65537, 2^29): the RNS layers "
            "assume t < every ciphertext prime")
    if not _primes.is_prime(t):
        raise ValueError(f"plain_modulus {t} must be prime")
    if (t - 1) % (2 * n) != 0:
        raise ValueError(
            f"plain_modulus {t} does not support batching for n={n}: "
            "need t ≡ 1 (mod 2n)")
    k = max(2, math.ceil(security.log_q / PRIME_BITS))
    l = k
    while (1 << (29 * l + 29)) <= 4 * t * n * (1 << (PRIME_BITS * k)):
        l += 1
    with PROCESS.time("tables.primes"):
        pool = _primes.find_ntt_primes(n, k + l + 1, bits=PRIME_BITS, exclude=(t,))
        gamma = _primes.find_ntt_primes(
            n, 1, bits=PRIME_BITS, exclude=tuple(pool) + (t,))[0]
    return SchemeParams(security=security, n=n, t=t,
                        q_primes=tuple(pool[:k]),
                        aux_primes=tuple(pool[k:k + l]),
                        m_sk=pool[k + l], gamma=gamma)


def default_params(poly_degree: int = 4096, log_q: int = 120, **kw) -> SchemeParams:
    """``make_scheme_params`` of ``SecurityParams(poly_degree, log_q, **kw)``."""
    return make_scheme_params(SecurityParams(poly_degree=poly_degree, log_q=log_q, **kw))
