"""Four-step negacyclic NTT as int8 matrix products on the tensor cores —
counterpart of ``fhe_tpu/ops/ntt_mxu.py`` (the JAX package's MXU engine).

The length-n transform, n = n1 * n2, becomes two dense modular matrix
products with a twiddle product between them (psi the 2n-th root, w = psi^2):

    i = i1 + n1*i2,  j = j2 + n2*j1
    X[j1, j2] = sum_i1 W[j1, i1] * T[i1, j2] * sum_i2 M[i1, i2] * V[i2, j2]
    M[i1, i2] = x_{i1 + n1*i2},  V[i2, j2] = psi^(n1 i2) w^(n1 i2 j2),
    T[i1, j2] = psi^i1 w^(i1 j2),  W[j1, i1] = w^(n2 i1 j1),

so X = W @ ((M @ V) * T) mod p.  The output is the natural-order
negacyclic NTT in [j1, j2] layout, not the bit-reversed order of
``ops/ntt.py``: forward, pointwise product and inverse here are consistent
with each other, and a closed loop (``polymul_negacyclic``, a tensor
product) gives the same residues as the other engine; NTT-form data of this
engine is never stored on a ciphertext or key.

A modular matrix product splits each operand (< 2^30) into four balanced
signed base-256 digits in [-128, 127] (the top one in [0, 64]), so the 16
digit-pair products are int8 x int8 -> int32 GEMMs (``torch._int_mm``: the
tensor cores on the card, a CPU GEMM on the host).  One GEMM per prime forms
all 16 pairs: the data's 4 digits are stacked as row blocks and the
matrix's 4 digits as column blocks, and the pairs with digit sum s are
added into the diagonal Q_s.  |Q_s| <= 49152 * L for a contraction of
length L <= 4096, so the int32 sums cannot overflow.  The recombination
sum_s 256^s Q_s mod p shifts each diagonal by OFF = 49152 * max(n1, n2)
(2 * OFF < p, so the shifted value is a residue), runs a base-256 Horner
sweep mod p, and subtracts the precomputed OFF * sum_s 256^s once.

The digit split, the diagonal sums, the Horner sweep and the twiddle
product are torch ops; they and the pointwise product reduce exactly in
int64, so every output is the fully reduced residue the JAX package's
Shoup and Barrett steps give (it keeps Shoup companions and Barrett
constants for those steps; this engine needs neither).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import primes as _primes
from . import modmath as mm

_LIMBS = 4
_BASE_BITS = 8
_BASE = 1 << _BASE_BITS
# worst |diagonal| per unit of contraction length: s = 3 pairs
# (0,3)+(1,2)+(2,1)+(3,0) with digit bounds [128, 128, 128, 64] on both sides
_DIAG_BOUND = 128 * 64 + 128 * 128 + 128 * 128 + 64 * 128  # 49152
# x + 128 * (1 + 256 + 256^2 + 256^3) has the base-256 digits d_i + 128 of
# the balanced digits d_i of x
_DIGIT_BIAS = 0x80808080
# torch._int_mm on the card takes more than 16 rows and an inner dimension
# that is a multiple of 8
_MIN_ROWS = 32
_INNER_ALIGN = 8


@dataclasses.dataclass(frozen=True)
class MXUNTTTables:
    """Per-prime four-step constants on one device, n = n1 * n2.

    The matrices are stored as the right-hand GEMM operand of one product
    per prime, int8 [k, c_pad, 4 * o]: row = contraction index c (zero rows
    pad it to a multiple of 8), column = digit * o + output index, where
    V [i2, j2] and Vi [j2, i2] (n^-1 folded in) are applied from the right
    and W [j1, i1] and Wi [i1, j1] from the left.  Twiddles are int32
    [k, n1, n2]."""

    p: torch.Tensor              # [k] int64
    horner_corr: torch.Tensor    # [k] int64, OFF * sum_s 256^s mod p
    n1: int
    n2: int
    v_gemm: torch.Tensor         # forward row matrix V
    w_gemm: torch.Tensor         # forward column matrix W
    t_mid: torch.Tensor          # forward mid twiddles T
    vi_gemm: torch.Tensor        # inverse counterparts
    wi_gemm: torch.Tensor
    ti_mid: torch.Tensor
    primes: tuple[int, ...] = ()

    @property
    def k(self) -> int:
        return self.p.shape[0]

    @property
    def n(self) -> int:
        return self.n1 * self.n2


_ROW_FIELDS = ("p", "horner_corr", "v_gemm", "w_gemm", "t_mid", "vi_gemm",
               "wi_gemm", "ti_mid")


def _limbs_host(mat: np.ndarray) -> np.ndarray:
    """uint32 [.., m, n] -> int8 [4, .., m, n] balanced signed base-256
    digits: d_i in [-128, 127], the top one in [0, 64] for values < 2^30.
    A value in [2^30, 2^32) would pass the digit count but break the top
    digit's bound that the Horner offset assumes, so it raises."""
    if not (mat < (1 << 30)).all():
        raise ValueError("matrix entry >= 2^30: the top digit would exceed 64")
    v = mat.astype(np.int64)
    out = []
    for _ in range(_LIMBS):
        d = v & (_BASE - 1)
        borrow = d >= _BASE // 2
        out.append((d - (borrow.astype(np.int64) << _BASE_BITS)).astype(np.int8))
        v = (v >> _BASE_BITS) + borrow
    if v.any():
        raise ValueError("leftover carry after all digits")
    return np.stack(out)


def _matrix(rows: int, cols: int, start, ratio, p: int) -> np.ndarray:
    """[rows, cols] uint32 with entry [a, b] = start(a) * ratio(a)^b mod p."""
    out = np.empty((rows, cols), dtype=np.uint32)
    for a in range(rows):
        acc, rb = start(a) % p, ratio(a)
        for b in range(cols):
            out[a, b] = acc
            acc = acc * rb % p
    return out


def _gemm_operand(limbs: np.ndarray, side: str) -> np.ndarray:
    """int8 [4, .., ..] digits of one matrix -> the [c_pad, 4 * o] right-hand
    GEMM operand: contraction rows (padded with zeros), digit-major columns.
    side 'right': the matrix is [c, o]; side 'left': it is [o, c]."""
    lm = limbs if side == "right" else limbs.transpose(0, 2, 1)   # [4, c, o]
    c, o = lm.shape[1:]
    op = lm.transpose(1, 0, 2).reshape(c, _LIMBS * o)
    pad = -c % _INNER_ALIGN
    return np.concatenate([op, np.zeros((pad, op.shape[1]), np.int8)]) if pad else op


@functools.lru_cache(maxsize=None)
def _build_host(n: int, n1: int, prime_tuple: tuple[int, ...]) -> dict:
    n2 = n // n1
    rows = {f: [] for f in ("v", "w", "t", "vi", "wi", "ti")}
    for p in prime_tuple:
        psi = _primes.negacyclic_psi(n, p)
        w = pow(psi, 2, p)
        ipsi, iw = pow(psi, -1, p), pow(w, -1, p)
        n_inv = pow(n, -1, p)
        v = _matrix(n2, n2, lambda a: pow(psi, n1 * a, p), lambda a: pow(w, n1 * a, p), p)
        t = _matrix(n1, n2, lambda a: pow(psi, a, p), lambda a: pow(w, a, p), p)
        wm = _matrix(n1, n1, lambda a: 1, lambda a: pow(w, n2 * a, p), p)
        # inverse: x = n^-1 * conjugate transform, M = ((Wi @ X) * Ti) @ Vi
        wi = _matrix(n1, n1, lambda a: 1, lambda a: pow(iw, n2 * a, p), p)
        ti = _matrix(n1, n2, lambda a: pow(ipsi, a, p), lambda a: pow(iw, a, p), p)
        # Vi [j2, i2] = n^-1 psi^(-n1 i2) w^(-n1 i2 j2): built [i2, j2], transposed
        vi = _matrix(n2, n2, lambda a: n_inv * pow(ipsi, n1 * a, p),
                     lambda a: pow(iw, n1 * a, p), p).T
        rows["v"].append(_gemm_operand(_limbs_host(v), "right"))
        rows["w"].append(_gemm_operand(_limbs_host(wm), "left"))
        rows["t"].append(t)
        rows["vi"].append(_gemm_operand(_limbs_host(np.ascontiguousarray(vi)), "right"))
        rows["wi"].append(_gemm_operand(_limbs_host(wi), "left"))
        rows["ti"].append(ti)
    return {f: np.stack(v) for f, v in rows.items()}


def build_mxu_tables(n: int, primes_list, n1: int | None = None,
                     device="cuda") -> MXUNTTTables:
    """Four-step tables for ``primes_list`` (30-bit primes) on ``device``.
    The JAX package's default split: n1 = 128 from n = 16384 on, else
    2^floor(log2(n) / 2) clamped to [64, 128]."""
    if n1 is None:
        n1 = 128 if n >= 16384 else max(64, min(128, 1 << ((n.bit_length() - 1) // 2)))
    primes = tuple(int(p) for p in primes_list)
    n2 = n // n1
    # the worst diagonal |Q_3| <= 49152 * max(n1, n2) must keep 2 * OFF < p
    # (the shifted diagonal a residue): p > 2^29 allows max(n1, n2) <= 4096
    if 2 * _DIAG_BOUND * max(n1, n2) >= (1 << 29):
        raise ValueError(
            f"contraction length max(n1,n2) = {max(n1, n2)} overflows the "
            f"signed-digit diagonal offset (max 4096) for n = {n}")
    for p in primes:
        if not (1 << 29) < p < (1 << 30):
            raise ValueError(f"MXU engine needs 30-bit primes, got {p}")
    host = _build_host(n, n1, primes)
    off = _DIAG_BOUND * max(n1, n2)
    geo = sum(_BASE ** s for s in range(2 * _LIMBS - 1))
    dev = mm.resolve_device(device)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return MXUNTTTables(
        p=torch.tensor(primes, dtype=torch.int64, device=dev),
        horner_corr=torch.tensor([off * geo % p for p in primes], dtype=torch.int64,
                                 device=dev),
        n1=n1, n2=n2,
        v_gemm=as_t(host["v"]), w_gemm=as_t(host["w"]),
        t_mid=as_t(host["t"].view(np.int32)),
        vi_gemm=as_t(host["vi"]), wi_gemm=as_t(host["wi"]),
        ti_mid=as_t(host["ti"].view(np.int32)), primes=primes)


def slice_tables(tb: MXUNTTTables, k: int) -> MXUNTTTables:
    """First-k-primes view (a level's q primes)."""
    if k == tb.k:
        return tb
    return dataclasses.replace(tb, **{f: getattr(tb, f)[:k] for f in _ROW_FIELDS},
                               primes=tb.primes[:k])


def slice_tables_last(tb: MXUNTTTables, k: int) -> MXUNTTTables:
    """Last-k-primes view (a level's Bsk base, m_sk last)."""
    if k == tb.k:
        return tb
    return dataclasses.replace(tb, **{f: getattr(tb, f)[tb.k - k:] for f in _ROW_FIELDS},
                               primes=tb.primes[tb.k - k:])


# ---------------------------------------------------------------------------
# modular matrix product through int8 digit GEMMs
# ---------------------------------------------------------------------------


def _data_limbs(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Residues x in [0, 2^30) -> int8 balanced signed base-256 digits, the
    digit axis (length 4) inserted at ``dim``; contiguous.  Unchecked: a
    value at or above 2^30 has a top digit above the 64 the Horner offset
    assumes and comes out silently wrong, so callers pass reduced residues."""
    y = x.to(torch.int64, memory_format=torch.contiguous_format) + _DIGIT_BIAS
    y = y.unsqueeze(dim)
    shape = [1] * y.dim()
    shape[dim] = _LIMBS
    shifts = torch.arange(0, _LIMBS * _BASE_BITS, _BASE_BITS, device=x.device).view(shape)
    return (((y >> shifts) & (_BASE - 1)) - _BASE // 2).to(torch.int8)


def _digit_products(a: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """a [k, 4, R, c] int8 digits of the data, mat [k, c_pad, 4 * o] (a
    table's GEMM operand) -> the limb-pair products [k, 4, R, 4, o] int32,
    one ``torch._int_mm`` per prime."""
    k, limbs, rows, c = a.shape
    c_pad, cols = mat.shape[1:]
    a = a.reshape(k, limbs * rows, c)
    r_pad = max(limbs * rows, _MIN_ROWS)
    if c_pad != c or r_pad != limbs * rows:
        a = F.pad(a, (0, c_pad - c, 0, r_pad - limbs * rows))
    out = torch.empty((k, r_pad, cols), dtype=torch.int32, device=a.device)
    for i in range(k):
        torch._int_mm(a[i], mat[i], out=out[i])
    return out[:, :limbs * rows].view(k, limbs, rows, limbs, cols // limbs)


def _diagonals(c: torch.Tensor) -> torch.Tensor:
    """[k, 4, R, 4, o] pair products -> [k, R, 7, o] diagonals
    Q_s = sum_{a + b = s} c[:, a, :, b]."""
    k, limbs, rows, _, o = c.shape
    q = torch.zeros((k, rows, 2 * limbs - 1, o), dtype=torch.int32, device=c.device)
    for a in range(limbs):
        q[:, :, a:a + limbs] += c[:, a]
    return q


def _horner_mod(qs, p: torch.Tensor, corr: torch.Tensor,
                contraction_bound: int) -> torch.Tensor:
    """sum_s 256^s * Q_s mod p for the signed int32 diagonals qs (a sequence
    of 7 tensors, |Q_s| <= 49152 * contraction_bound); p and corr int64,
    broadcast against them.  Each diagonal is shifted by OFF = 49152 *
    contraction_bound into [0, 2 OFF), a residue; the Horner sweep runs mod
    p and the correction OFF * sum_s 256^s is subtracted once.  int32."""
    off = _DIAG_BOUND * contraction_bound
    r = qs[-1].to(torch.int64) + off
    for q in reversed(qs[:-1]):
        r = torch.remainder(torch.add(q + off, r, alpha=_BASE), p)
    return mm.sub_mod(r, corr, p).to(torch.int32)


def _matmul_mod(x: torch.Tensor, mat: torch.Tensor, p: torch.Tensor,
                corr: torch.Tensor, contraction_bound: int, side: str) -> torch.Tensor:
    """Modular matrix product on the last two axes of x [k, B, m, c]:
    side 'right' x @ M (contracting c; M [c, o]); side 'left' M @ x
    (contracting m; M [o, m]), with mat the table's GEMM operand of M and p,
    corr [k] int64.  Returns [k, B, m, o] ('right') or [k, B, o, c]
    ('left'), int32 residues."""
    k, batch = x.shape[:2]
    if side == "left":
        x = x.transpose(2, 3)                  # M @ x = (x^T @ M^T)^T
    rows = x.shape[2]
    prod = _digit_products(_data_limbs(x, 1).view(k, _LIMBS, batch * rows, -1), mat)
    out = _horner_mod(_diagonals(prod).unbind(2), p.view(k, 1, 1), corr.view(k, 1, 1),
                      contraction_bound).view(k, batch, rows, -1)
    return out if side == "right" else out.transpose(2, 3)


def ntt_forward(x: torch.Tensor, tb: MXUNTTTables) -> torch.Tensor:
    """[k, B, n] -> [k, B, n] natural-order four-step negacyclic NTT (output
    index j = j2 + n2*j1 stored flat)."""
    k, batch, n = x.shape
    p, corr, lmax = tb.p, tb.horner_corr, max(tb.n1, tb.n2)
    m = x.reshape(k, batch, tb.n2, tb.n1).transpose(2, 3)       # M [i1, i2]
    a = _matmul_mod(m, tb.v_gemm, p, corr, lmax, "right")       # [i1, j2]
    a = mm.mul_mod(a, tb.t_mid[:, None], p.view(k, 1, 1, 1))
    out = _matmul_mod(a, tb.w_gemm, p, corr, lmax, "left")      # [j1, j2]
    return out.reshape(k, batch, n)


def ntt_inverse(y: torch.Tensor, tb: MXUNTTTables) -> torch.Tensor:
    """Inverse of ``ntt_forward`` (four-step order in, coefficients out)."""
    k, batch, n = y.shape
    p, corr, lmax = tb.p, tb.horner_corr, max(tb.n1, tb.n2)
    a = _matmul_mod(y.reshape(k, batch, tb.n1, tb.n2), tb.wi_gemm, p, corr, lmax,
                    "left")                                     # [i1, j2]
    a = mm.mul_mod(a, tb.ti_mid[:, None], p.view(k, 1, 1, 1))
    m = _matmul_mod(a, tb.vi_gemm, p, corr, lmax, "right")      # [i1, i2]
    return m.transpose(2, 3).reshape(k, batch, n)               # i = i1 + n1*i2


def pointwise_mul(a: torch.Tensor, b: torch.Tensor, tb: MXUNTTTables) -> torch.Tensor:
    """Product of [k, ..., n] residues in this engine's NTT domain."""
    return mm.mul_mod(a, b, tb.p.view(-1, *([1] * (a.dim() - 1))))


def polymul_negacyclic(a: torch.Tensor, b: torch.Tensor, tb: MXUNTTTables) -> torch.Tensor:
    """Negacyclic product of [k, B, n] coefficient-domain residues on this
    engine (both operands through one forward call); the same residues as
    ``ntt.polymul_negacyclic``."""
    batch = a.shape[1]
    f = ntt_forward(torch.cat([a, b], dim=1), tb)
    return ntt_inverse(pointwise_mul(f[:, :batch], f[:, batch:], tb), tb)
