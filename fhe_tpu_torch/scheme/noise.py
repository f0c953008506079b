"""Variance-based noise model — the host-float part of ``fhe_tpu/scheme/noise.py``
that the linear ops use.

Every noise coefficient is a zero-mean random variable of variance V, carried
as log2(V); the budget comes from a D-sigma tail bound on the infinity norm:

    BFV:  phase = Delta*m + e,   budget = log2(q_L / (2 t)) - log2(D sqrt(V))
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
