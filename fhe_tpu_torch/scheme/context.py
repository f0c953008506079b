"""SchemeContext: the precomputed constants on one device, at every level.

Counterpart of ``fhe_tpu/scheme/context.py:make_context``, restricted to
what the ported BFV and BGV ops read.  Level L is the modulus chain with
its last L primes dropped (q_L = q_0 * ... * q_{k-1-L}).  For each L the
context holds the decryption and Δ constants, the relinearization digit
constants, the BEHZ multiply constants (SmMRq, FastFloor,
Shenoy-Kumaresan) for the level's Bsk base, the grouped gadget weights,
BGV's exact centred reduction q_L -> {t}, and (for L < k - 1) the
modulus-switch constants that drop q_{k-1-L}, BFV's and BGV's.  With
``use_mxu`` it also holds the four-step engine's tables.  The
level's NTT and multiply tables are zero-copy row views of the level-0
tables: its first k - L q primes, and the last ``bsk_counts[L]`` Bsk
primes, m_sk last.  The Galois gather tables are not fields: the
automorphism kernel computes its indices, and ``galois_perm_tables``
(coefficient domain) and ``eval_perm`` / ``eval_perm_inv`` (NTT domain,
the hoisted rotations) build the host tables on request.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from .. import primes as _primes
from ..ops import modmath as mm
from ..ops import ntt as _ntt
from ..ops import ntt_mxu as _ntt_mxu
from ..ops import rns as _rns
from ..params import SchemeParams, SecurityParams, make_scheme_params


@dataclasses.dataclass(frozen=True)
class SchemeContext:
    params: SchemeParams
    ntt_q: _ntt.NTTTables                          # q basis, level 0
    # Per-level constants; index = level L, 0 .. k-1 (mod_switch: 0 .. k-2).
    # (q, Bsk) tables with t * n^-1 as the inverse normalisation: the
    # multiply's tensor products come out scaled by t at no cost.  Row views
    # of level 0's: the first k-L q rows, the last bsk_counts[L] Bsk rows
    # (the aux primes + m_sk, m_sk last).
    mul_levels: tuple[tuple[_ntt.NTTTables, _ntt.NTTTables], ...]
    bsk_counts: tuple[int, ...]                    # Bsk primes of each level
    smq_levels: tuple[_rns.SmMRqConsts, ...]       # q_L -> Bsk_L centred lift
    floor_levels: tuple[_rns.FastFloorConsts, ...]  # q_L -> Bsk_L floor(t*x/q_L)
    sk_levels: tuple[_rns.SKConsts, ...]           # Bsk_L -> q_L exact conversion
    # relinearization digits D_j = [c2_j * (q_L/q_j)^-1]_{q_j}
    inv_qhat_levels: tuple[torch.Tensor, ...]      # [k-L]
    inv_qhat_shoup_levels: tuple[torch.Tensor, ...]  # [k-L] Shoup companions
    # grouped gadget weights ks_group_conv_tables(q_L primes, ks_omega)
    ks_conv_levels: tuple[torch.Tensor, ...]       # [k-L, kd_L, ks_omega]
    dec_levels: tuple[_rns.DecryptConsts, ...]     # gamma-trick decryption
    delta_levels: tuple[tuple[torch.Tensor, torch.Tensor], ...]  # (Δ_L mod q_i, Shoup)
    mod_switch: tuple[_rns.ModSwitchConsts, ...]   # level L -> L + 1
    # BGV: decryption's centred reduction q_L -> {t}, and the t-corrected
    # modulus switch, level L -> L + 1
    bgv_dec_levels: tuple[_rns.SmMRqConsts, ...]
    bgv_mod_switch: tuple[_rns.BGVModSwitchConsts, ...]
    # the four-step engine's tables (ops/ntt_mxu.py) of the q and Bsk bases,
    # level 0 (a level's are row views), or None: with them the multiply's
    # tensor products run on the engine (use_mxu)
    ntt_q_mxu: _ntt_mxu.MXUNTTTables | None = None
    ntt_bsk_mxu: _ntt_mxu.MXUNTTTables | None = None

    @property
    def k(self) -> int:
        return self.params.k

    @property
    def n(self) -> int:
        return self.params.n

    @property
    def device(self) -> torch.device:
        return self.ntt_q.device

    @property
    def use_mxu(self) -> bool:
        return self.ntt_q_mxu is not None

    # level 0's entries under their level-0 names
    @property
    def mul_tables(self) -> tuple[_ntt.NTTTables, _ntt.NTTTables]:
        return self.mul_levels[0]

    @property
    def smq(self) -> _rns.SmMRqConsts:
        return self.smq_levels[0]

    @property
    def floor_c(self) -> _rns.FastFloorConsts:
        return self.floor_levels[0]

    @property
    def sk_c(self) -> _rns.SKConsts:
        return self.sk_levels[0]

    @property
    def inv_qhat(self) -> torch.Tensor:
        return self.inv_qhat_levels[0]


def galois_permutation(n: int, g: int) -> tuple[np.ndarray, np.ndarray]:
    """Gather form of the automorphism a(x) -> a(x^g) on Z[x]/(x^n + 1):
    source coefficient i goes to position g*i mod 2n, negated if that is
    >= n; returns the inverse map (src [n] int32, neg [n] bool) with
    out[j] = +-a[src[j]]."""
    if g % 2 != 1:
        raise ValueError(f"galois element must be odd, got {g}")
    e = np.arange(n, dtype=np.int64) * g % (2 * n)
    src = np.empty(n, dtype=np.int32)
    neg = np.empty(n, dtype=bool)
    src[e % n] = np.arange(n, dtype=np.int32)
    neg[e % n] = e >= n
    return src, neg


@functools.lru_cache(maxsize=None)
def galois_perm_tables(n: int, g: int) -> tuple[np.ndarray, np.ndarray]:
    """Cached (src, neg) host tables of ``galois_permutation`` for any odd
    g, read-only; a caller that needs them on a device copies them there
    (``torch.as_tensor(src, device=...)``)."""
    src, neg = galois_permutation(n, g)
    src.flags.writeable = False
    neg.flags.writeable = False
    return src, neg


@functools.lru_cache(maxsize=None)
def _bit_reversal(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    return np.array([_primes.bit_reverse(j, bits) for j in range(n)], dtype=np.int64)


@functools.lru_cache(maxsize=None)
def eval_perm(n: int, g: int) -> np.ndarray:
    """NTT-domain form of the automorphism a(x) -> a(x^g): a pure gather,
    out[j] = in[src[j]], returned as the read-only src [n] int32.

    The merged-psi forward transform stores at position j the evaluation at
    psi^(2 brv(j) + 1); phi_g evaluates at the g-th powers, so
    2 brv(src[j]) + 1 = g (2 brv(j) + 1) mod 2n.  No sign flips: the
    negacyclic wrap only exists in the coefficient representation."""
    if g % 2 != 1:
        raise ValueError(f"galois element must be odd, got {g}")
    brv = _bit_reversal(n)
    src = brv[(g * (2 * brv + 1) % (2 * n) - 1) // 2].astype(np.int32)
    src.flags.writeable = False
    return src


@functools.lru_cache(maxsize=None)
def eval_perm_inv(n: int, g: int) -> np.ndarray:
    """Inverse of ``eval_perm``'s gather, inv[src[j]] = j (read-only [n]
    int32).  Gathering key material with it moves the hoisted rotations'
    automorphism off the data path:
    sum_j perm_g(F_j) K_j == perm_g(sum_j F_j inv_perm_g(K_j))."""
    inv = np.argsort(eval_perm(n, g)).astype(np.int32)
    inv.flags.writeable = False
    return inv


@functools.lru_cache(maxsize=None)
def ks_group_conv_tables(primes: tuple[int, ...], omega: int) -> np.ndarray:
    """Grouped-gadget weights (SecurityParams.ks_omega): read-only cw
    [k, kd, omega] uint32, kd = ceil(k / omega), with
    cw[i, g, j] = (q_Jg / q_{J_g[j]}) mod primes[i] for the g-th group
    J_g = primes[g*omega : (g+1)*omega], zero where the last group is short.

    The grouped digit D_g = [c (q/q_Jg)^-1]_{q_Jg} comes from the per-prime
    digits y_j = [c (q/q_j)^-1]_{q_j} by CRT interpolation,
    sum_{j in J_g} y_j (q_Jg/q_j) = D_g + alpha q_Jg with alpha < omega; the
    gadget absorbs alpha exactly (q_Jg (q/q_Jg) = q = 0 mod q) and it only
    scales the key error (noise.keyswitch_add)."""
    k = len(primes)
    kd = -(-k // omega)
    # member m of every group ([kd], 1 past the short last group) mod each prime
    ps = np.array(primes, dtype=np.uint64)
    members = np.ones(kd * omega, dtype=np.uint64)
    members[:k] = ps
    members = members.reshape(kd, omega)[None] % ps[:, None, None]   # [k, kd, omega]
    cw = np.ones((k, kd, omega), dtype=np.uint64)
    for jl in range(omega):
        for m in range(omega):
            if m != jl:
                cw[:, :, jl] = cw[:, :, jl] * members[:, :, m] % ps[:, None]
    cw[:, kd - 1, omega - (kd * omega - k):] = 0
    cw = cw.astype(np.uint32)
    cw.flags.writeable = False
    return cw


def default_galois_elements(n: int) -> tuple[int, ...]:
    """Galois elements for power-of-two row rotations in both directions,
    3^(±2^i) mod 2n for 2^i < n/2, then the column swap g = 2n - 1."""
    m = 2 * n
    elems = []
    step = 1
    while step < n // 2:
        elems.append(pow(3, step, m))
        elems.append(pow(3, -step, m))
        step *= 2
    elems.append(m - 1)
    return tuple(dict.fromkeys(elems))


@functools.lru_cache(maxsize=None)
def _level_host(primes: tuple[int, ...], t: int) -> tuple[np.ndarray, ...]:
    """(Δ_L mod q_i, Shoup, (q_L/q_i)^-1 mod q_i, Shoup) for one level,
    Δ_L = floor(q_L / t)."""
    q = math.prod(primes)
    delta_mod = [q // t % p for p in primes]
    inv_qhat = [pow(q // p, -1, p) for p in primes]
    return (np.array(delta_mod, dtype=np.uint32), mm.shoup_array(delta_mod, primes),
            np.array(inv_qhat, dtype=np.uint32), mm.shoup_array(inv_qhat, primes))


def level_aux_count(params: SchemeParams, level: int) -> int:
    """Aux primes of level L's Bsk base.  Level 0 takes them all (the
    oracle's multiply is bit-exact with it); a deeper level the smallest
    suffix of aux_primes with prod * m_sk > 4 t n q_L, the bound that sizes
    the level-0 base, so that m_sk stays the last Bsk prime."""
    aux = params.aux_primes
    if level == 0:
        return len(aux)
    need = 4 * params.t * params.n * math.prod(params.q_primes[:params.k - level])
    count, prod = 0, params.m_sk
    while prod <= need:
        count += 1
        prod *= aux[-count]
    return count


def make_context(params: SchemeParams | None = None, device="cuda",
                 use_mxu: bool = False, **security_kw) -> SchemeContext:
    """Build the constants on ``device`` (default the card).  ``use_mxu``
    routes the ciphertext multiply's tensor products through the four-step
    int8 GEMM engine (``ops/ntt_mxu.py``) and builds its tables; the JAX
    package keeps it an explicit opt-in, as here."""
    dev = mm.resolve_device(device)
    if params is None:
        params = make_scheme_params(SecurityParams(**security_kw))
    omega = params.security.ks_omega
    if omega < 1:
        raise ValueError(f"ks_omega must be >= 1, got {omega}")
    ntt_q = _ntt.build_tables(params.n, params.q_primes, dev)
    tq, tbsk = _ntt.build_mul_tables(
        ntt_q, _ntt.build_tables(params.n, params.bsk_primes, dev), params.t)
    lv = {f: [] for f in ("mul_levels", "bsk_counts", "smq_levels", "floor_levels",
                          "sk_levels", "inv_qhat_levels", "inv_qhat_shoup_levels",
                          "ks_conv_levels", "dec_levels", "delta_levels", "mod_switch",
                          "bgv_dec_levels", "bgv_mod_switch")}
    for level in range(params.k):
        chain = params.q_primes[:params.k - level]
        n_aux = level_aux_count(params, level)
        aux = params.aux_primes[len(params.aux_primes) - n_aux:]
        bsk = aux + (params.m_sk,)
        delta, delta_sh, inv_qhat, inv_qhat_sh = (mm.u32_tensor(v, dev)
                                                  for v in _level_host(chain, params.t))
        lv["mul_levels"].append((_ntt.slice_tables(tq, len(chain)),
                                 _ntt.slice_tables_last(tbsk, len(bsk))))
        lv["bsk_counts"].append(len(bsk))
        lv["smq_levels"].append(_rns.make_sm_mrq(chain, bsk, params.m_tilde, dev))
        lv["floor_levels"].append(_rns.make_fast_floor(chain, bsk, dev))
        lv["sk_levels"].append(_rns.make_sk(aux, params.m_sk, chain, dev))
        lv["inv_qhat_levels"].append(inv_qhat)
        lv["inv_qhat_shoup_levels"].append(inv_qhat_sh)
        lv["ks_conv_levels"].append(mm.u32_tensor(ks_group_conv_tables(chain, omega), dev))
        lv["dec_levels"].append(_rns.make_decrypt(chain, params.t, params.gamma, dev))
        lv["delta_levels"].append((delta, delta_sh))
        lv["bgv_dec_levels"].append(_rns.make_sm_mrq(chain, (params.t,), params.m_tilde,
                                                      dev))
        if len(chain) >= 2:
            lv["mod_switch"].append(_rns.make_mod_switch(chain, dev))
            lv["bgv_mod_switch"].append(_rns.make_bgv_mod_switch(chain, params.t, dev))
    mxu = {}
    if use_mxu:
        mxu = dict(ntt_q_mxu=_ntt_mxu.build_mxu_tables(params.n, params.q_primes, device=dev),
                   ntt_bsk_mxu=_ntt_mxu.build_mxu_tables(params.n, params.bsk_primes,
                                                         device=dev))
    return SchemeContext(params=params, ntt_q=ntt_q, **mxu,
                         **{f: tuple(v) for f, v in lv.items()})
