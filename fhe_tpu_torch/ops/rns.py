"""RNS / CRT layer — counterpart of ``fhe_tpu/ops/rns.py``.

Base conversions and exact rounded scalings, all-integer (BEHZ):

* fast base conversion q -> C (adds alpha*q, alpha < k);
* SmMRq: the exact centred lift q -> Bsk through the m~ = 2^16 lane;
* FastFloor: floor(t*x/q) - alpha in Bsk;
* FastBConvSK: the exact Shenoy-Kumaresan conversion Bsk -> q;
* decryption: m = round(t * x / q) mod t for the phase x = c0 + c1*s,
  through the gamma trick: the digits of [gamma*t*x]_q are summed into a t
  lane and a gamma lane, and the centred gamma lane corrects the t lane's
  rounding;
* modulus switching: round(x / q_last) in the remaining primes, and BGV's
  t-corrected form (x - d) / q_last with d = x mod q_last, d = 0 mod t;
* the exact host CRT (``to_rns_host`` / ``from_rns_host``) of the noise
  diagnostics, in pure Python.

Each is bit-exact with its ``fhe_tpu.ops.rns`` counterpart (the JAX
package's t = 65537 Fermat decryption lane gives the same bits as the
generic one here).  ``bsk_branch_fused`` (and ``_batch``),
``fast_bconv_sk`` (and ``fast_bconv_sk_digits``), ``fast_floor`` and
``fast_floor_sk`` are also the plain versions of the CUDA kernels in
``ops/rns_cuda.py``, and ``tensor_product_lift`` (``sm_mrq``, then the
tensor product) that of ``ntt_cuda.tensor_product``'s Lift lane.  Residues are
int32 tensors; products are formed in int64 and reduced with ``%``.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from . import modmath as mm
from . import ntt as _ntt

_MASK16 = 0xFFFF


def _col(v: torch.Tensor, ndim: int = 3) -> torch.Tensor:
    """[m] constants -> [m, 1, ...] int64 for an ndim-dimensional tensor."""
    return v.to(torch.int64).view(-1, *([1] * (ndim - 1)))


def _consts(cls, host: dict, array_fields, device, **extra):
    return cls(**{f: mm.u32_tensor(v, device) if f in array_fields else v
                  for f, v in host.items()}, **extra)


# ---------------------------------------------------------------------------
# fast base conversion  (src base P -> dst base C, adds alpha*P, alpha < k)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BaseConvConsts:
    p_src: torch.Tensor            # [k]
    inv_phat: torch.Tensor         # [k]     (P/p_i)^-1 mod p_i
    inv_phat_shoup: torch.Tensor   # [k]
    p_dst: torch.Tensor            # [l]
    phat_mod_dst: torch.Tensor     # [l, k]  (P/p_i) mod c_j
    phat_shoup_dst: torch.Tensor   # [l, k]
    # [l, 3] per dst prime: 2^32 mod c_j, its Shoup companion, floor(2^32/c_j)
    # (the CUDA kernels reduce a 64-bit sum of products with them)
    dst_wide: torch.Tensor


def wide_consts(primes) -> np.ndarray:
    """[m, 3] uint32: 2^32 mod p, its Shoup companion and floor(2^32 / p)
    for each prime p < 2^30."""
    if any(not 1 < p < 1 << 30 for p in primes):
        raise ValueError(f"expected primes below 2^30, got {primes}")
    r = [(1 << 32) % p for p in primes]
    return np.array([[ri, mm.shoup_precompute(ri, p), (1 << 32) // p]
                     for ri, p in zip(r, primes)], dtype=np.uint32).reshape(len(primes), 3)


@functools.lru_cache(maxsize=None)
def _base_conv_host(src: tuple[int, ...], dst: tuple[int, ...]) -> dict:
    P = math.prod(src)
    inv_phat = [pow(P // p, -1, p) for p in src]
    phat = [[(P // p) % c for p in src] for c in dst]
    return dict(
        dst_wide=wide_consts(dst),
        p_src=np.array(src, dtype=np.uint32),
        inv_phat=np.array(inv_phat, dtype=np.uint32),
        inv_phat_shoup=mm.shoup_array(inv_phat, src),
        p_dst=np.array(dst, dtype=np.uint32),
        phat_mod_dst=np.array(phat, dtype=np.uint32).reshape(len(dst), len(src)),
        phat_shoup_dst=np.array(
            [mm.shoup_array(row, [c] * len(src)) for row, c in zip(phat, dst)],
            dtype=np.uint32).reshape(len(dst), len(src)),
    )


def make_base_conv(src_primes, dst_primes, device="cuda") -> BaseConvConsts:
    host = _base_conv_host(tuple(int(p) for p in src_primes),
                           tuple(int(p) for p in dst_primes))
    return _consts(BaseConvConsts, host, host.keys(), device)


def _accumulate(y: torch.Tensor, cc: BaseConvConsts) -> torch.Tensor:
    """sum_i y_i * (P/p_i) mod c_j for every dst prime j: [k, B, n] digits
    -> [l, B, n]."""
    terms = (y.to(torch.int64)[None] * cc.phat_mod_dst.to(torch.int64)[
        :, :, None, None]) % _col(cc.p_dst, 4)
    return (terms.sum(1) % _col(cc.p_dst)).to(torch.int32)


def fast_base_conv(x: torch.Tensor, cc: BaseConvConsts) -> torch.Tensor:
    """[k, B, n] residues in the src base -> [l, B, n] residues of
    x + alpha*P in the dst base."""
    y = x.to(torch.int64) * _col(cc.inv_phat) % _col(cc.p_src)
    return _accumulate(y, cc)


# ---------------------------------------------------------------------------
# SmMRq: exact centred lift q -> Bsk via the m~ correction
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SmMRqConsts:
    conv: BaseConvConsts              # q -> Bsk
    mt_times_inv_phat: torch.Tensor   # [k]  [m~ * (q/q_i)^-1]_{q_i}
    mt_times_inv_phat_shoup: torch.Tensor
    phat_mod_mt: torch.Tensor         # [k]  (q/q_i) mod 2^16
    q_mod_dst: torch.Tensor           # [l]  q mod c
    q_shoup_dst: torch.Tensor
    inv_mt_dst: torch.Tensor          # [l]  m~^-1 mod c
    inv_mt_shoup_dst: torch.Tensor
    inv_q_mt: int                     # q^-1 mod 2^16


SM_MRQ_ARRAYS = ("mt_times_inv_phat", "mt_times_inv_phat_shoup", "phat_mod_mt",
                 "q_mod_dst", "q_shoup_dst", "inv_mt_dst", "inv_mt_shoup_dst")


@functools.lru_cache(maxsize=None)
def _sm_mrq_host(src: tuple[int, ...], dst: tuple[int, ...], m_tilde: int) -> dict:
    if m_tilde != 1 << 16:
        raise ValueError(f"SmMRq needs m_tilde = 2^16, got {m_tilde}")
    Q = math.prod(src)
    mt_inv_phat = [pow(Q // p, -1, p) * m_tilde % p for p in src]
    q_mod = [Q % c for c in dst]
    inv_mt = [pow(m_tilde, -1, c) for c in dst]
    return dict(
        mt_times_inv_phat=np.array(mt_inv_phat, dtype=np.uint32),
        mt_times_inv_phat_shoup=mm.shoup_array(mt_inv_phat, src),
        phat_mod_mt=np.array([(Q // p) % m_tilde for p in src], dtype=np.uint32),
        q_mod_dst=np.array(q_mod, dtype=np.uint32),
        q_shoup_dst=mm.shoup_array(q_mod, dst),
        inv_mt_dst=np.array(inv_mt, dtype=np.uint32),
        inv_mt_shoup_dst=mm.shoup_array(inv_mt, dst),
        inv_q_mt=pow(Q, -1, m_tilde),
    )


def make_sm_mrq(src_primes, dst_primes, m_tilde: int = 1 << 16,
                device="cuda") -> SmMRqConsts:
    src = tuple(int(p) for p in src_primes)
    dst = tuple(int(p) for p in dst_primes)
    return _consts(SmMRqConsts, _sm_mrq_host(src, dst, m_tilde), SM_MRQ_ARRAYS,
                   device, conv=make_base_conv(src, dst, device))


def sm_mrq(x: torch.Tensor, sc: SmMRqConsts) -> torch.Tensor:
    """Centred lift of x ([k, B, n] residues in q) into the dst base
    [l, B, n]: the result represents x or x - q, whichever is centred."""
    cc = sc.conv
    y = x.to(torch.int64) * _col(sc.mt_times_inv_phat) % _col(cc.p_src)
    conv = _accumulate(y, cc).to(torch.int64)                   # [l, B, n]
    lane = ((y & _MASK16) * _col(sc.phat_mod_mt)).sum(0) & _MASK16
    alpha = (lane * sc.inv_q_mt) & _MASK16                      # [B, n]
    c = _col(cc.p_dst)
    # centred alpha mod c: alpha < 2^15 -> alpha, else c - (2^16 - alpha)
    alpha_c = torch.where(alpha < (1 << 15), alpha, c - ((1 << 16) - alpha))
    centred = (conv - alpha_c * _col(sc.q_mod_dst) % c) % c
    return (centred * _col(sc.inv_mt_dst) % c).to(torch.int32)


def tensor_product_lift(x: torch.Tensor, y: torch.Tensor, sc: SmMRqConsts,
                        tb_dst: _ntt.NTTTables) -> torch.Tensor:
    """The n < 1024 multiply's Bsk side: the centred lift of the
    ciphertext halves x, y ([k, 2, n] in q) into the dst base, then their
    tensor product there with the (t-folded) tables ``tb_dst``; [l, 3, n]."""
    lift = sm_mrq(torch.cat([x, y], dim=1), sc)                 # [l, 4, n]
    return _ntt.tensor_product(lift[:, :2], lift[:, 2:], tb_dst)


# ---------------------------------------------------------------------------
# FastFloor: floor(t*x/q) - alpha in the Bsk base
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FastFloorConsts:
    conv: BaseConvConsts         # q -> Bsk
    inv_q_dst: torch.Tensor      # [l]  q^-1 mod c
    inv_q_shoup_dst: torch.Tensor


def make_fast_floor(src_primes, dst_primes, device="cuda") -> FastFloorConsts:
    src = tuple(int(p) for p in src_primes)
    dst = tuple(int(p) for p in dst_primes)
    inv_q = [pow(math.prod(src), -1, c) for c in dst]
    return FastFloorConsts(
        conv=make_base_conv(src, dst, device),
        inv_q_dst=mm.u32_tensor(np.array(inv_q, dtype=np.uint32), device),
        inv_q_shoup_dst=mm.u32_tensor(mm.shoup_array(inv_q, dst), device))


def fast_floor(tx_q: torch.Tensor, tx_dst: torch.Tensor,
               fc: FastFloorConsts) -> torch.Tensor:
    """Residues of t*x in q ([k, B, n]) and in the dst base ([l, B, n]) ->
    floor(t*x/q) - alpha (alpha < k) in the dst base."""
    c = _col(fc.conv.p_dst)
    conv = fast_base_conv(tx_q, fc.conv).to(torch.int64)
    diff = (tx_dst.to(torch.int64) - conv) % c
    return (diff * _col(fc.inv_q_dst) % c).to(torch.int32)


# ---------------------------------------------------------------------------
# FastBConvSK: exact signed conversion Bsk -> q (Shenoy-Kumaresan)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SKConsts:
    conv_q: BaseConvConsts       # aux base B -> q
    conv_sk: BaseConvConsts      # B -> {m_sk}
    B_mod_q: torch.Tensor        # [k]
    B_shoup_q: torch.Tensor
    m_sk: int
    inv_B_sk: int                # B^-1 mod m_sk
    inv_B_sk_shoup: int


def make_sk(aux_primes, m_sk: int, dst_primes, device="cuda") -> SKConsts:
    aux = tuple(int(p) for p in aux_primes)
    dst = tuple(int(p) for p in dst_primes)
    B = math.prod(aux)
    inv_B_sk = pow(B, -1, m_sk)
    b_mod = [B % c for c in dst]
    return SKConsts(
        conv_q=make_base_conv(aux, dst, device),
        conv_sk=make_base_conv(aux, (m_sk,), device),
        B_mod_q=mm.u32_tensor(np.array(b_mod, dtype=np.uint32), device),
        B_shoup_q=mm.u32_tensor(mm.shoup_array(b_mod, dst), device),
        m_sk=int(m_sk), inv_B_sk=inv_B_sk,
        inv_B_sk_shoup=mm.shoup_precompute(inv_B_sk, m_sk))


def fast_bconv_sk(x_bsk: torch.Tensor, sk: SKConsts) -> torch.Tensor:
    """x_bsk [l+1, B, n] (aux rows, then the m_sk row) -> the exact signed
    value's [k, B, n] residues in q."""
    x_aux, x_msk = x_bsk[:-1], x_bsk[-1].to(torch.int64)
    conv_q = fast_base_conv(x_aux, sk.conv_q).to(torch.int64)     # [k, B, n]
    conv_sk = fast_base_conv(x_aux, sk.conv_sk)[0].to(torch.int64)
    msk = sk.m_sk
    alpha = (conv_sk - x_msk) % msk * sk.inv_B_sk % msk           # [B, n]
    c = _col(sk.conv_q.p_dst)
    # centred alpha mod c: alpha (alpha <= m_sk/2) or c - (m_sk - alpha)
    alpha_c = torch.where(alpha <= (msk >> 1), alpha, c - (msk - alpha))
    return ((conv_q - alpha_c * _col(sk.B_mod_q) % c) % c).to(torch.int32)


def relin_digits(c: torch.Tensor, inv_qhat: torch.Tensor,
                 primes: torch.Tensor) -> torch.Tensor:
    """The relinearization's per-prime gadget digits [c_j * (q/q_j)^-1]_{q_j}
    of [k, *B, n] coefficient-domain residues c (inv_qhat: the [k] table
    (q/q_j)^-1 mod q_j of the primes)."""
    return (c.to(torch.int64) * _col(inv_qhat, c.dim())
            % _col(primes, c.dim())).to(torch.int32)


def fast_bconv_sk_digits(x_bsk: torch.Tensor, sk: SKConsts,
                         inv_qhat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``fast_bconv_sk`` of x_bsk [l+1, 3B, n], whose rows are components 0,
    1 and 2 of B elements (component-major), and the relinearization digits
    of its c2 rows: ([k, 3B, n], [k, B, n])."""
    out = fast_bconv_sk(x_bsk, sk)
    k, rows, n = out.shape
    c2 = out.view(k, 3, rows // 3, n)[:, 2]
    return out, relin_digits(c2, inv_qhat, sk.conv_q.p_dst)


def fast_floor_sk(tx_q: torch.Tensor, tx_bsk: torch.Tensor, fc: FastFloorConsts,
                  sk: SKConsts, inv_qhat: torch.Tensor | None = None):
    """The floor into Bsk and the exact conversion back to q: [k, B, n], and
    with ``inv_qhat`` also the digits of the c2 rows (``fast_bconv_sk_digits``)."""
    floored = fast_floor(tx_q, tx_bsk, fc)
    if inv_qhat is None:
        return fast_bconv_sk(floored, sk)
    return fast_bconv_sk_digits(floored, sk, inv_qhat)


def bsk_branch_fused_batch(ab: torch.Tensor, tx_q: torch.Tensor,
                           sc: SmMRqConsts, fc: FastFloorConsts,
                           tb_bsk: _ntt.NTTTables) -> torch.Tensor:
    """The multiply's whole Bsk branch for B ciphertext pairs: SmMRq lift of
    ab = a || b ([k, 4, B, n] in q), the tensor product in Bsk with the
    t-folded tables ``tb_bsk``, then FastFloor against the t-scaled q-side
    product tx_q [k, 3, B, n].  Returns the floored [kb, 3, B, n]."""
    k, _, batch, n = ab.shape
    kb = tb_bsk.k
    lift = sm_mrq(ab.reshape(k, 4 * batch, n), sc).view(kb, 4, batch, n)
    tx_bsk = _ntt.tensor_product_batch(lift[:, :2], lift[:, 2:], tb_bsk)
    return fast_floor(tx_q.reshape(k, 3 * batch, n),
                      tx_bsk.view(kb, 3 * batch, n), fc).view(kb, 3, batch, n)


def bsk_branch_fused(ab: torch.Tensor, tx_q: torch.Tensor, sc: SmMRqConsts,
                     fc: FastFloorConsts, tb_bsk: _ntt.NTTTables) -> torch.Tensor:
    """``bsk_branch_fused_batch`` of one pair: ab [k, 4, n], tx_q [k, 3, n]
    -> the floored [kb, 3, n]."""
    return bsk_branch_fused_batch(ab[:, :, None], tx_q[:, :, None], sc, fc,
                                  tb_bsk)[:, :, 0]


@dataclasses.dataclass(frozen=True)
class DecryptConsts:
    """Per-prime arrays are [k] int32 tensors (uint32 bits) on one device;
    scalars are host ints, passed to the kernel by value."""

    p_src: torch.Tensor             # [k]
    gt_inv_phat: torch.Tensor       # [k]  [gamma*t*(q/q_i)^-1]_{q_i}
    gt_inv_phat_shoup: torch.Tensor
    phat_mod_t: torch.Tensor        # [k]  (q/q_i) mod t
    phat_shoup_t: torch.Tensor      # [k]  Shoup companions mod t
    phat_mod_g: torch.Tensor        # [k]  (q/q_i) mod gamma
    t: int
    gamma: int
    neg_inv_q_t: int                # [-q^-1]_t
    neg_inv_q_t_shoup: int
    neg_inv_q_g: int                # [-q^-1]_gamma
    inv_gamma_t: int                # gamma^-1 mod t
    inv_gamma_t_shoup: int
    gamma_mod_t: int                # [gamma]_t
    one_shoup_t: int                # floor(2^32/t): generic mod-t reduce
    gamma_mu: int                   # Barrett mu for gamma


ARRAY_FIELDS = ("p_src", "gt_inv_phat", "gt_inv_phat_shoup", "phat_mod_t",
                "phat_shoup_t", "phat_mod_g")


@functools.lru_cache(maxsize=None)
def _decrypt_host(src: tuple[int, ...], t: int, gamma: int) -> dict:
    Q = math.prod(src)
    gt_inv = [gamma * t % p * pow(Q // p, -1, p) % p for p in src]
    phat_t = [(Q // p) % t for p in src]
    neg_inv_q_t = (-pow(Q, -1, t)) % t
    inv_gamma_t = pow(gamma, -1, t)
    return dict(
        p_src=np.array(src, dtype=np.uint32),
        gt_inv_phat=np.array(gt_inv, dtype=np.uint32),
        gt_inv_phat_shoup=mm.shoup_array(gt_inv, src),
        phat_mod_t=np.array(phat_t, dtype=np.uint32),
        phat_shoup_t=mm.shoup_array(phat_t, [t] * len(src)),
        phat_mod_g=np.array([(Q // p) % gamma for p in src], dtype=np.uint32),
        t=t,
        gamma=gamma,
        neg_inv_q_t=neg_inv_q_t,
        neg_inv_q_t_shoup=mm.shoup_precompute(neg_inv_q_t, t),
        neg_inv_q_g=(-pow(Q, -1, gamma)) % gamma,
        inv_gamma_t=inv_gamma_t,
        inv_gamma_t_shoup=mm.shoup_precompute(inv_gamma_t, t),
        gamma_mod_t=gamma % t,
        one_shoup_t=mm.shoup_precompute(1, t),
        gamma_mu=mm.barrett_precompute(gamma),
    )


def make_decrypt(src_primes, t: int, gamma: int, device="cuda") -> DecryptConsts:
    if not (65537 <= t < (1 << 29)):
        raise ValueError(
            f"decrypt_scale needs 65537 <= t < 2^29, got {t} (see params.py)")
    host = _decrypt_host(tuple(int(p) for p in src_primes), t, gamma)
    return _consts(DecryptConsts, host, ARRAY_FIELDS, device)


def decrypt_scale(x: torch.Tensor, dc: DecryptConsts) -> torch.Tensor:
    """x: [k, B, n] int32 residues of the phase, coefficient domain.
    Returns [B, n] int32 plaintext coefficients mod t."""
    col = lambda v: v.to(torch.int64).view(-1, 1, 1)
    t, g = dc.t, dc.gamma
    z = x.to(torch.int64) * col(dc.gt_inv_phat) % col(dc.p_src)
    acc_t = (z * col(dc.phat_mod_t) % t).sum(0) % t
    acc_g = (z * col(dc.phat_mod_g) % g).sum(0) % g
    s_t = acc_t * dc.neg_inv_q_t % t
    s_g = acc_g * dc.neg_inv_q_g % g
    # centre s_g: e_hat = s_g (s_g <= gamma/2) or s_g - gamma, taken mod t
    e_mod_t = torch.where(s_g <= (g >> 1), s_g % t, (s_g - dc.gamma_mod_t) % t)
    return ((s_t - e_mod_t) % t * dc.inv_gamma_t % t).to(torch.int32)


# ---------------------------------------------------------------------------
# modulus switching: drop the last prime with rounding
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModSwitchConsts:
    p_keep: torch.Tensor          # [k-1]
    inv_qlast: torch.Tensor       # [k-1]  q_last^-1 mod p_i
    inv_qlast_shoup: torch.Tensor
    q_last: int


def make_mod_switch(primes, device="cuda") -> ModSwitchConsts:
    ps = tuple(int(p) for p in primes)
    keep, last = ps[:-1], ps[-1]
    inv = [pow(last, -1, p) for p in keep]
    return ModSwitchConsts(
        p_keep=mm.u32_tensor(np.array(keep, dtype=np.uint32), device),
        inv_qlast=mm.u32_tensor(np.array(inv, dtype=np.uint32), device),
        inv_qlast_shoup=mm.u32_tensor(mm.shoup_array(inv, keep), device),
        q_last=last)


def mod_switch_drop_last(x: torch.Tensor, mc: ModSwitchConsts) -> torch.Tensor:
    """[k, B, n] -> [k-1, B, n]: round(x / q_last) in the remaining primes,
    x_last taken centred (x_last or x_last - q_last).  Elementwise, so plain
    PyTorch on either device, as in the JAX package (which computes it
    outside any Pallas kernel)."""
    x_keep, x_last = x[:-1].to(torch.int64), x[-1].to(torch.int64)
    p = _col(mc.p_keep, x.dim())
    # x - x_last is divisible by q_last: subtract x_last (centred: x_last, or
    # x_last - q_last when it is above q_last / 2)
    corr = torch.where(x_last <= (mc.q_last >> 1), x_last, x_last - mc.q_last)
    return ((x_keep - corr) % p * _col(mc.inv_qlast, x.dim()) % p).to(torch.int32)


# ---------------------------------------------------------------------------
# BGV modulus switching: drop the last prime with the mod-t correction
# d = t * [[x * t^-1]]_{q_last}, so that d = x (mod q_last) and d = 0 (mod t)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BGVModSwitchConsts:
    p_keep: torch.Tensor          # [k-1]
    inv_qlast: torch.Tensor       # [k-1]  q_last^-1 mod p_i
    inv_qlast_shoup: torch.Tensor
    q_last: int
    t: int
    inv_t_qlast: int              # t^-1 mod q_last


def make_bgv_mod_switch(primes, t: int, device="cuda") -> BGVModSwitchConsts:
    ms = make_mod_switch(primes, device)
    return BGVModSwitchConsts(p_keep=ms.p_keep, inv_qlast=ms.inv_qlast,
                              inv_qlast_shoup=ms.inv_qlast_shoup, q_last=ms.q_last,
                              t=int(t), inv_t_qlast=pow(int(t), -1, ms.q_last))


def bgv_mod_switch_drop_last(x: torch.Tensor, mc: BGVModSwitchConsts) -> torch.Tensor:
    """[k, B, n] -> [k-1, B, n]: (x - d) / q_last in the remaining primes, with
    d = t * v, v = [x_last * t^-1]_{q_last} taken centred (v, or v - q_last
    above q_last / 2).  Elementwise, so plain PyTorch on either device, as in
    the JAX package (which computes it outside any Pallas kernel)."""
    x_keep, x_last = x[:-1].to(torch.int64), x[-1].to(torch.int64)
    p = _col(mc.p_keep, x.dim())
    v = x_last * mc.inv_t_qlast % mc.q_last
    vc = torch.where(v <= (mc.q_last >> 1), v, v - mc.q_last)
    d = torch.remainder(vc * mc.t, p)
    return ((x_keep - d) % p * _col(mc.inv_qlast, x.dim()) % p).to(torch.int32)


# ---------------------------------------------------------------------------
# host big integers <-> RNS (the noise diagnostics)
# ---------------------------------------------------------------------------


def to_rns_host(coeffs, primes_list) -> np.ndarray:
    """[n] Python ints -> [k, n] uint32 residues."""
    return np.stack([np.array([int(c) % int(p) for c in coeffs], dtype=np.uint32)
                     for p in primes_list])


def from_rns_host(res, primes_list) -> list[int]:
    """[k, n] residues (numpy, or a tensor on any device) -> [n] Python ints
    in [0, Q): the exact CRT on the host."""
    if isinstance(res, torch.Tensor):
        res = res.cpu().numpy()
    rows = np.asarray(res).astype(np.int64).tolist()
    ps = [int(p) for p in primes_list]
    Q = math.prod(ps)
    mults = [Q // p * pow(Q // p, -1, p) % Q for p in ps]
    return [sum(r * m for r, m in zip(col, mults)) % Q for col in zip(*rows)]
