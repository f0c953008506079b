"""Variance-based noise model — the host-float part of ``fhe_tpu/scheme/noise.py``
that the ported ops use.

Every noise coefficient is a zero-mean random variable of variance V, carried
as log2(V); the budget comes from a D-sigma tail bound on the infinity norm:

    BFV:  phase = Delta*m + e,   budget = log2(q_L / (2 t)) - log2(D sqrt(V))
    BGV:  phase = m + t*e,       budget = log2(q_L / 2) - log2(t D sqrt(V))

(the same number: BGV's budget functions are BFV's).
"""

from __future__ import annotations

import math

from ..params import SchemeParams

D_TAIL = 6.0
_LOG_D = math.log2(D_TAIL)


def logaddexp2(a: float, b: float) -> float:
    """log2(2^a + 2^b) without overflow."""
    hi, lo = max(a, b), min(a, b)
    return hi + math.log2(1.0 + 2.0 ** (lo - hi))


def _q_at(params: SchemeParams, level: int) -> int:
    return math.prod(params.q_primes[: params.k - level])


def _cap(params: SchemeParams, level: int) -> float:
    """log2(q_L / (2t)): the budget at zero noise."""
    return math.log2(_q_at(params, level)) - 1.0 - math.log2(params.t)


def bfv_budget(params: SchemeParams, level: int, log2_var: float) -> float:
    return _cap(params, level) - _LOG_D - max(float(log2_var), -40.0) / 2.0


def bfv_variance(params: SchemeParams, level: int, budget: float) -> float:
    """budget bits -> log2(V)."""
    return 2.0 * (_cap(params, level) - _LOG_D - budget)


def bgv_budget(params: SchemeParams, level: int, log2_var: float) -> float:
    return bfv_budget(params, level, log2_var)


def bgv_variance(params: SchemeParams, level: int, budget: float) -> float:
    return bfv_variance(params, level, budget)


def fresh_variance(params: SchemeParams) -> float:
    """e = u * e_pk + e1 + s * e2 (u, s ternary of weight h, e_* Gaussian):
    V = sigma^2 (2h + 1)."""
    sig2 = params.security.sigma ** 2
    return math.log2(sig2 * (2 * params.security.hamming_weight + 1))


def add(lv1: float, lv2: float) -> float:
    return logaddexp2(lv1, lv2)


def multiply_plain(params: SchemeParams, lv: float) -> float:
    """e' = e * m, an n-term convolution with E[m^2] = t^2/3."""
    return lv + math.log2(params.n * (params.t ** 2) / 3.0)


def bfv_multiply(params: SchemeParams, lv1: float, lv2: float) -> float:
    """Dominant terms of the BFV tensor-product noise after t/q scaling:

        e' ~ m1*e2 + m2*e1 + t (alpha1*e2 + alpha2*e1) + r

    with alpha_i = (ct_i(s) - Delta m_i - e_i)/q of coefficient variance
    ~ (h+1)/12, plus a rounding term r of variance ~ (1+h)/12.  All
    products are n-term convolutions."""
    n, t = params.n, params.t
    h = params.security.hamming_weight
    alpha_var = (h + 1) / 12.0
    m_var = (t ** 2) / 3.0
    scale = math.log2(n * (m_var + (t ** 2) * alpha_var))
    return logaddexp2(scale + logaddexp2(lv1, lv2), math.log2((1 + h) / 12.0))


def bgv_multiply(params: SchemeParams, lv1: float, lv2: float) -> float:
    """The phase product: e' = m1*e2 + m2*e1 + t*e1*e2 (n-term convolutions)."""
    n, t = params.n, params.t
    cross = math.log2(n * (t ** 2) / 3.0) + logaddexp2(lv1, lv2)
    prod = math.log2(n) + 2 * math.log2(t) + lv1 + lv2
    return logaddexp2(cross, prod)


def bfv_mod_switch(params: SchemeParams, level_from: int, lv: float) -> float:
    """e' = e / q_last + eps * m + r: the rounding term r = d0 + d1 * s
    (variance (1 + h)/12), and eps * m because Delta_L / q_last =
    Delta_{L+1} + eps, eps in (-1, 1), computed exactly in integers
    (m uniform mod t, E[m^2] = t^2/3)."""
    t = params.t
    q_last = params.q_primes[params.k - 1 - level_from]
    q_from = _q_at(params, level_from)
    eps = ((q_from // t) - (q_from // q_last // t) * q_last) / q_last
    h = params.security.hamming_weight
    const = (1 + h) / 12.0 + (eps ** 2) * (t ** 2) / 3.0
    return logaddexp2(lv - 2.0 * math.log2(q_last), math.log2(const))


def bgv_mod_switch(params: SchemeParams, level_from: int, lv: float) -> float:
    """BGV's t-corrected switch keeps the plaintext in the low bits exactly
    (no eps * m term): e' = e / q_last + r, Var(r) = (1 + h)/12."""
    q_last = float(params.q_primes[params.k - 1 - level_from])
    h = params.security.hamming_weight
    return logaddexp2(lv - 2.0 * math.log2(q_last), math.log2((1 + h) / 12.0))


def galois(lv: float) -> float:
    """Automorphisms permute (and negate) coefficients: variance unchanged;
    the key switch that follows adds keyswitch_add."""
    return lv


def keyswitch_add(params: SchemeParams, level: int) -> float:
    """Variance added by RNS-digit key switching: sum over gadget digits of
    n * ((omega * q_Jd)^2 / 3) * sigma^2 (the digits are uncentred residues
    in [0, q_Jd); omega primes per digit, 1 for the classic gadget)."""
    sig2 = params.security.sigma ** 2
    omega = params.security.ks_omega
    primes_l = params.q_primes[: params.k - level]
    v = 0.0
    for g in range(0, len(primes_l), omega):
        qj = float(math.prod(primes_l[g: g + omega]))
        v += params.n * ((omega * qj) ** 2 / 3.0) * sig2
    return math.log2(v)
