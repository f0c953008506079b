"""Negacyclic NTT over RNS prime stacks — counterpart of ``fhe_tpu/ops/ntt.py``.

Order: merged-ψ Cooley–Tukey forward, natural order in, bit-reversed order
out; Gentleman–Sande inverse, bit-reversed in, natural out, ending with the
×n⁻¹ scale.  NTT-form keys, ciphertexts and plain operands cross between the
two packages, so this order is fixed, not a free choice.

Layout: residue tensors are ``[k, batch, n]`` int32, prime-major.  Tables
keep the compact ``psi_br [k, n]`` form (stage m reads entries m..2m-1);
the CUDA kernels (``ops/ntt_cuda.py``) index the same tables.

The functions here are the plain PyTorch versions of those kernels: exact
int64 products reduced with ``%``.  They run on any device; the package
routes to them only for CPU tensors.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import primes as _primes
from ..utils import native as _native
from . import galois as _galois
from . import modmath as mm


@dataclasses.dataclass(frozen=True)
class NTTTables:
    """Per-prime constants on one device.  Tables are [k, n], scalars [k];
    int32 tensors carrying uint32 bits (Shoup companions and Barrett
    constants use the full 32 bits)."""

    p: torch.Tensor              # [k] primes
    mu: torch.Tensor             # [k] Barrett floor(2^61/p); 0 for small p (t)
    psi_br: torch.Tensor         # [k, n] psi^brv(i)
    psi_br_shoup: torch.Tensor
    ipsi_br: torch.Tensor        # [k, n] psi^-brv(i)
    ipsi_br_shoup: torch.Tensor
    n_inv: torch.Tensor          # [k]
    n_inv_shoup: torch.Tensor
    primes: tuple[int, ...] = ()  # the same primes as host ints

    @property
    def k(self) -> int:
        return self.p.shape[0]

    @property
    def n(self) -> int:
        return self.psi_br.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.p.device


FIELDS = tuple(f.name for f in dataclasses.fields(NTTTables)
               if f.name != "primes")


def _mu(p: int) -> int:
    """Barrett constant of a 30-bit prime; 0 for a small modulus (t for the
    encoder), whose transforms use Shoup butterflies only."""
    return mm.barrett_precompute(p) if (1 << 29) < p < (1 << 30) else 0


def _native_tables(n: int, prime_tuple: tuple[int, ...]) -> dict | None:
    """The tables from the native library (``utils/native.py``), or None
    unless it makes every prime's."""
    built = [_native.build_ntt_tables(n, p) for p in prime_tuple]
    if any(b is None for b in built):
        return None
    cols = list(zip(*built))
    return {"p": np.array(prime_tuple, dtype=np.uint32),
            "mu": np.array([_mu(p) for p in prime_tuple], dtype=np.uint32),
            **{f: np.stack(c) for f, c in zip(FIELDS[2:6], cols[:4])},
            "n_inv": np.array(cols[4], dtype=np.uint32),
            "n_inv_shoup": np.array(cols[5], dtype=np.uint32)}


@functools.lru_cache(maxsize=None)
def _build_tables_np(n: int, prime_tuple: tuple[int, ...]) -> dict:
    """Host-side table build, exact Python ints -> numpy uint32: the native
    library's where it is loaded, else the Python body below (the same
    bits)."""
    fast = _native_tables(n, prime_tuple)
    if fast is not None:
        return fast
    bits = n.bit_length() - 1
    brv = np.array([_primes.bit_reverse(i, bits) for i in range(n)])
    rows = {f: [] for f in FIELDS}
    for p in prime_tuple:
        psi = _primes.negacyclic_psi(n, p)
        ipsi = pow(psi, -1, p)
        pows = np.empty(n, dtype=object)
        ipows = np.empty(n, dtype=object)
        x = y = 1
        for i in range(n):
            pows[i] = x
            ipows[i] = y
            x = x * psi % p
            y = y * ipsi % p
        psi_br = pows[brv]
        ipsi_br = ipows[brv]
        n_inv = pow(n, -1, p)
        rows["p"].append(p)
        rows["mu"].append(_mu(p))
        rows["psi_br"].append(psi_br.astype(np.uint32))
        rows["psi_br_shoup"].append(mm.shoup_array(psi_br, [p] * n))
        rows["ipsi_br"].append(ipsi_br.astype(np.uint32))
        rows["ipsi_br_shoup"].append(mm.shoup_array(ipsi_br, [p] * n))
        rows["n_inv"].append(n_inv)
        rows["n_inv_shoup"].append(mm.shoup_precompute(n_inv, p))
    return {f: np.stack(v).astype(np.uint32) for f, v in rows.items()}


def build_tables(n: int, primes_list, device="cuda") -> NTTTables:
    """NTT tables for ``primes_list`` on ``device`` (default the card)."""
    primes = tuple(int(p) for p in primes_list)
    host = _build_tables_np(n, primes)
    return NTTTables(**{f: mm.u32_tensor(v, device) for f, v in host.items()},
                     primes=primes)


def slice_tables(tb: NTTTables, k: int) -> NTTTables:
    """First-k-primes view (a modulus-switched level): zero-copy row views
    of every field (tb itself for all of its primes).  The CUDA wrappers
    pass ``data_ptr()``, which includes a view's offset, so the kernels read
    a view as they read whole tables."""
    if k == tb.k:
        return tb
    return dataclasses.replace(tb, **{f: getattr(tb, f)[:k] for f in FIELDS},
                               primes=tb.primes[:k])


def slice_tables_last(tb: NTTTables, k: int) -> NTTTables:
    """Last-k-primes view: the leveled Bsk base shrinks from the front, so
    m_sk, the Shenoy-Kumaresan anchor, stays last at every level."""
    if k == tb.k:
        return tb
    return dataclasses.replace(tb, **{f: getattr(tb, f)[tb.k - k:] for f in FIELDS},
                               primes=tb.primes[tb.k - k:])


def build_mul_tables(q_tables: NTTTables, bsk_tables: NTTTables,
                     t: int) -> tuple[NTTTables, NTTTables]:
    """(q-base, Bsk-base) tables for the multiply's tensor products, with
    the scale by t folded into the inverse normalisation: n_inv is
    t * n^-1 mod p (and its Shoup companion), so the inverse transform
    emits t * INTT(...) at no cost.  The twiddle tensors are the given
    tables' own.  Counterpart of ``fhe_tpu.ops.ntt_pallas.build_mul_tables``
    at level 0 (all q primes; all Bsk primes, m_sk last); a deeper level's
    tables are the row views ``slice_tables`` and ``slice_tables_last``."""

    def scaled(tb: NTTTables) -> NTTTables:
        t_ninv = [t * pow(tb.n, -1, p) % p for p in tb.primes]
        return dataclasses.replace(
            tb, n_inv=mm.u32_tensor(np.array(t_ninv, dtype=np.uint32), tb.device),
            n_inv_shoup=mm.u32_tensor(mm.shoup_array(t_ninv, tb.primes), tb.device))

    return scaled(q_tables), scaled(bsk_tables)


def _p(tb: NTTTables, ndim: int) -> torch.Tensor:
    """[k, 1, ...] int64 prime broadcast for an ndim-dimensional tensor."""
    return tb.p.to(torch.int64).view(-1, *([1] * (ndim - 1)))


def ntt_forward(a: torch.Tensor, tb: NTTTables) -> torch.Tensor:
    """Forward negacyclic NTT of [k, batch, n] residues, natural ->
    bit-reversed order."""
    k, b, n = a.shape
    p = _p(tb, 4)
    x = a.to(torch.int64).contiguous()
    m = 1
    while m < n:
        t = n // (2 * m)
        w = tb.psi_br[:, m:2 * m].to(torch.int64).view(k, 1, m, 1)
        x = x.view(k, b, m, 2, t)
        u = x[:, :, :, 0]
        v = (x[:, :, :, 1] * w) % p
        x = torch.stack((mm.add_mod(u, v, p), mm.sub_mod(u, v, p)),
                        dim=3).view(k, b, n)
        m *= 2
    return x.to(torch.int32)


def ntt_inverse(a: torch.Tensor, tb: NTTTables) -> torch.Tensor:
    """Inverse negacyclic NTT, bit-reversed -> natural order, times n^-1."""
    k, b, n = a.shape
    p = _p(tb, 4)
    x = a.to(torch.int64).contiguous()
    m = n // 2
    while m >= 1:
        t = n // (2 * m)
        w = tb.ipsi_br[:, m:2 * m].to(torch.int64).view(k, 1, m, 1)
        x = x.view(k, b, m, 2, t)
        u = x[:, :, :, 0]
        v = x[:, :, :, 1]
        x = torch.stack((mm.add_mod(u, v, p), (mm.sub_mod(u, v, p) * w) % p),
                        dim=3).view(k, b, n)
        m //= 2
    return ((x * tb.n_inv.to(torch.int64).view(k, 1, 1)) % _p(tb, 3)
            ).to(torch.int32)


# The column form of the kernels (csrc/column.cuh) as a plain model of its
# index maps: a row of n = 2^L as 2^s blocks of b = n / 2^s positions.  The
# column launches run the stages that pair elements of different blocks on
# the columns (element j = c + i b is element i of column c), the block
# launches the rest on each block.  Every function below takes and returns
# int64 [k, B, n] residues; their stages are ntt_forward's and
# ntt_inverse's butterflies, so a chain of them gives those transforms' bits.

def _stage(x: torch.Tensor, dim: int, w: torch.Tensor, tb: NTTTables,
           inverse: bool) -> torch.Tensor:
    """One radix-2 stage on x, its pairs along ``dim``, w broadcast against
    either half: Cooley-Tukey (u + v w, u - v w) or Gentleman-Sande
    (u + v, (u - v) w)."""
    u, v = x.select(dim, 0), x.select(dim, 1)
    p = _p(tb, u.dim())
    if inverse:
        pair = (mm.add_mod(u, v, p), (mm.sub_mod(u, v, p) * w) % p)
    else:
        v = (v * w) % p
        pair = (mm.add_mod(u, v, p), mm.sub_mod(u, v, p))
    return torch.stack(pair, dim=dim)


def _block_twiddles(table: torch.Tensor, s: int, level: int) -> torch.Tensor:
    """A block stage's twiddles, 2^level groups a block: group g of block h
    at (2^s + h) 2^level + g (the row's stage, m = 2^(s + level), group
    h 2^level + g), as [k, 1, 2^s, 2^level, 1]."""
    h = torch.arange(1 << s, device=table.device)
    idx = (((1 << s) + h)[:, None] << level) + torch.arange(1 << level, device=table.device)
    return table[:, idx].to(torch.int64)[:, None, :, :, None]


def column_forward_stages(x: torch.Tensor, tb: NTTTables, s: int) -> torch.Tensor:
    """The forward's column launch: stage l < s pairs element i of each
    column with i + 2^(s-1-l) under psi_br[2^l + g], g = i >> (s - l)."""
    k, batch, n = x.shape
    for l in range(s):
        w = tb.psi_br[:, 1 << l:2 << l].to(torch.int64).view(k, 1, 1 << l, 1, 1)
        x = _stage(x.reshape(k, batch, 1 << l, 2, 1 << (s - 1 - l), n >> s), 3, w, tb, False)
    return x.reshape(k, batch, n)


def block_forward_stages(x: torch.Tensor, tb: NTTTables, s: int) -> torch.Tensor:
    """The forward's block launch: each block of n / 2^s positions through
    the stages below the column ones, distance b/2 down to 1."""
    k, batch, n = x.shape
    blk = n >> s
    for l in range(blk.bit_length() - 1):
        x = _stage(x.reshape(k, batch, 1 << s, 1 << l, 2, blk >> (l + 1)), 4,
                   _block_twiddles(tb.psi_br, s, l), tb, False)
    return x.reshape(k, batch, n)


def block_inverse_stages(x: torch.Tensor, tb: NTTTables, s: int) -> torch.Tensor:
    """The inverse's block launch: each block through the inverse stages of
    distance 1 up to b/2."""
    k, batch, n = x.shape
    logb = (n >> s).bit_length() - 1
    for q in range(logb):
        level = logb - 1 - q
        x = _stage(x.reshape(k, batch, 1 << s, 1 << level, 2, 1 << q), 4,
                   _block_twiddles(tb.ipsi_br, s, level), tb, True)
    return x.reshape(k, batch, n)


def column_inverse_stages(x: torch.Tensor, tb: NTTTables, s: int) -> torch.Tensor:
    """The inverse's column launch: stage l < s pairs element i of each
    column with i + 2^l under ipsi_br[2^(s-1-l) + g], g = i >> (l + 1);
    then times n^-1."""
    k, batch, n = x.shape
    for l in range(s):
        m = 1 << (s - 1 - l)
        w = tb.ipsi_br[:, m:2 * m].to(torch.int64).view(k, 1, m, 1, 1)
        x = _stage(x.reshape(k, batch, m, 2, 1 << l, n >> s), 3, w, tb, True)
    return (x.reshape(k, batch, n) * tb.n_inv.to(torch.int64).view(k, 1, 1)) % _p(tb, 3)


def ntt_forward_columns(a: torch.Tensor, tb: NTTTables, s: int) -> torch.Tensor:
    """``ntt_forward`` of [k, batch, n] as the column form runs it with s
    column stages: the column launch, then the block launch."""
    x = column_forward_stages(a.to(torch.int64), tb, s)
    return block_forward_stages(x, tb, s).to(torch.int32)


def ntt_inverse_columns(a: torch.Tensor, tb: NTTTables, s: int) -> torch.Tensor:
    """``ntt_inverse`` of [k, batch, n] as the column form runs it: the
    block launch, then the column launch."""
    x = block_inverse_stages(a.to(torch.int64), tb, s)
    return column_inverse_stages(x, tb, s).to(torch.int32)


def keyswitch_columns(d: torch.Tensor, keys_t: torch.Tensor, tb: NTTTables,
                      s: int) -> torch.Tensor:
    """keyswitch_fused_batch's classic lane as its column form chains it:
    the column launch (each digit [kd, B, n] reduced mod p_i, its column
    stages), the block launch (each digit's block stages, the sums of
    digit x key[i, j, c] for c = 0, 1, their block inverse stages) and the
    inverse column launch; returns [k, 2, B, n]."""
    k, kd, _, n = keys_t.shape
    batch = d.shape[-2]
    dr = torch.remainder(d.to(torch.int64)[None], _p(tb, 4)).reshape(k, kd * batch, n)
    f = block_forward_stages(column_forward_stages(dr, tb, s), tb, s)
    prod = mm.mul_mod(f.view(k, kd, 1, batch, n), keys_t[:, :, :, None].to(torch.int64),
                      _p(tb, 5))
    acc = torch.remainder(prod.sum(1), _p(tb, 4)).reshape(k, 2 * batch, n)
    out = column_inverse_stages(block_inverse_stages(acc, tb, s), tb, s)
    return out.view(k, 2, batch, n).to(torch.int32)


def pointwise_mul(a: torch.Tensor, b: torch.Tensor,
                  tb: NTTTables) -> torch.Tensor:
    """Hadamard product of [k, ..., n] NTT-domain residues."""
    return mm.mul_mod(a, b, _p(tb, a.dim()))


def polymul_negacyclic(a: torch.Tensor, b: torch.Tensor,
                       tb: NTTTables) -> torch.Tensor:
    """Negacyclic product of [k, batch, n] coefficient-domain residues:
    forward transforms, the pointwise product, the inverse transform."""
    return ntt_inverse(pointwise_mul(ntt_forward(a, tb), ntt_forward(b, tb), tb), tb)


def mul_by_ntt_operand_batch(u: torch.Tensor, w_ntt: torch.Tensor,
                             tb: NTTTables) -> torch.Tensor:
    """INTT(NTT(u_b) ⊙ w_c) for B coefficient-domain polynomials u [k, B, n]
    against the c rows of a shared [k, c, n] NTT-form operand; returns
    [k, c, B, n]."""
    k, batch, n = u.shape
    c = w_ntt.shape[1]
    prod = pointwise_mul(ntt_forward(u, tb)[:, None], w_ntt[:, :, None], tb)
    return ntt_inverse(prod.reshape(k, c * batch, n), tb).view(k, c, batch, n)


def mul_by_ntt_operand(u: torch.Tensor, w_ntt: torch.Tensor,
                       tb: NTTTables) -> torch.Tensor:
    """INTT(NTT(u) ⊙ w_c) for a [k, 1, n] coefficient-domain u against the
    c rows of a [k, c, n] NTT-form operand; returns [k, c, n]."""
    return mul_by_ntt_operand_batch(u, w_ntt, tb)[:, :, 0]


def tensor_product_batch(x: torch.Tensor, y: torch.Tensor,
                         tb: NTTTables) -> torch.Tensor:
    """(c0, c1, c2) = (x0*y0, x0*y1 + x1*y0, x1*y1) of B pairs of
    coefficient-domain ciphertext halves x, y [k, 2, B, n], negacyclic;
    returns [k, 3, B, n].  With the multiply's tables (``build_mul_tables``)
    the result is t times the product."""
    k, _, batch, n = x.shape
    f = ntt_forward(torch.cat([x, y], dim=1).reshape(k, 4 * batch, n), tb)
    a0, a1, b0, b1 = f.view(k, 4, batch, n).unbind(1)
    c1 = mm.add_mod(pointwise_mul(a0, b1, tb), pointwise_mul(a1, b0, tb),
                    _p(tb, 3))
    prod = torch.stack([pointwise_mul(a0, b0, tb), c1, pointwise_mul(a1, b1, tb)],
                       dim=1)
    return ntt_inverse(prod.view(k, 3 * batch, n), tb).view(k, 3, batch, n)


def tensor_product(x: torch.Tensor, y: torch.Tensor,
                   tb: NTTTables) -> torch.Tensor:
    """``tensor_product_batch`` of one pair of [k, 2, n] halves; returns
    [k, 3, n]."""
    return tensor_product_batch(x[:, :, None], y[:, :, None], tb)[:, :, 0]


def _galois_digits(d: torch.Tensor, tb: NTTTables, g: int) -> torch.Tensor:
    """The per-prime digits [kd, B, n] of phi_g(c1) from those of c1: digit
    j at x is d_j[src] negated mod its own q_j where the automorphism flips
    the sign (``galois.coeff_source``), the same residues as the digits of
    the permuted c1."""
    kd, _, n = d.shape
    src, neg = _galois.coeff_source(n, pow(g, -1, 2 * n), d.device)
    q = tb.p[:kd].to(torch.int64).view(kd, 1, 1)
    dg = d.to(torch.int64).index_select(2, src)
    return torch.where(neg, (q - dg) % q, dg).to(torch.int32)


def keyswitch_fused_batch(d: torch.Tensor, keys_t: torch.Tensor,
                          tb: NTTTables, prereduced: bool = False,
                          g: int | None = None,
                          c0: torch.Tensor | None = None) -> torch.Tensor:
    """INTT(sum_j NTT([d_j,b]_{p_i}) ⊙ key[i, j, c]) for c = 0, 1 and each of
    B elements: d a [kd, B, n] stack of gadget digits (digit j a residue mod
    its own q_j), keys_t the shared [k, kd, 2, n] NTT-form key material,
    prime-major.  ``prereduced=True`` takes d as [k, kd, B, n] per-prime
    residues (grouped gadget digits span several primes, so one row cannot
    hold them) and uses them as they are.  Returns the [k, 2, B, n]
    coefficient-domain key-switch corrections.

    With a Galois element ``g`` (the Galois lane, classic digits, kd = k): d
    holds the digits of an un-permuted c1, and the result is the rotated
    ciphertext (phi_g(c0) + delta0, delta1) of the key switch of phi_g(c1),
    c0 the [k, B, n] component 0."""
    k, kd, _, n = keys_t.shape
    batch = d.shape[-2]
    if g is not None:
        d = _galois_digits(d, tb, g)
    dr = d if prereduced else torch.remainder(
        d.to(torch.int64)[None], _p(tb, 4)).to(torch.int32)
    f = ntt_forward(dr.reshape(k, kd * batch, n), tb).view(k, kd, 1, batch, n)
    prod = mm.mul_mod(f, keys_t[:, :, :, None], _p(tb, 5))      # [k, kd, 2, B, n]
    acc = torch.remainder(prod.to(torch.int64).sum(1), _p(tb, 4))
    out = ntt_inverse(acc.to(torch.int32).view(k, 2 * batch, n),
                      tb).view(k, 2, batch, n)
    if g is None:
        return out
    rot = _galois.automorphism_fused(c0[:, None], (pow(g, -1, 2 * n),) * batch, tb.p)
    return torch.stack([mm.add_mod(out[:, 0], rot[:, 0], tb.p.view(-1, 1, 1)), out[:, 1]], dim=1)


def keyswitch_fused(d: torch.Tensor, keys_t: torch.Tensor,
                    tb: NTTTables, prereduced: bool = False,
                    g: int | None = None,
                    c0: torch.Tensor | None = None) -> torch.Tensor:
    """``keyswitch_fused_batch`` of one [kd, n] digit stack ([k, kd, n] when
    prereduced; with ``g``, c0 [k, n]); returns the [k, 2, n]
    coefficient-domain key-switch correction, or with ``g`` the rotated
    ciphertext."""
    return keyswitch_fused_batch(d.unsqueeze(-2), keys_t, tb, prereduced, g,
                                 None if c0 is None else c0[:, None])[:, :, 0]


def _inverse_pairs(acc: torch.Tensor, tb: NTTTables) -> torch.Tensor:
    """[k, B, 2, n] NTT-domain sums (int64) -> the [k, 2, B, n] coefficient
    domain."""
    k, batch, _, n = acc.shape
    acc = torch.remainder(acc, _p(tb, 4)).to(torch.int32)
    return ntt_inverse(acc.transpose(1, 2).reshape(k, 2 * batch, n),
                       tb).view(k, 2, batch, n)


def _gathered(acc: torch.Tensor, elements) -> torch.Tensor:
    """Element b of the [k, B, 2, n] NTT-domain sums gathered by
    phi_{elements[b]} (``galois.ntt_source``)."""
    n = acc.shape[-1]
    return torch.stack([acc[:, b].index_select(-1, _galois.ntt_source(n, int(g), acc.device))
                        for b, g in enumerate(elements)], dim=1)


def _galois_rows(acc: torch.Tensor, tb: NTTTables, elements,
                 c0: torch.Tensor) -> torch.Tensor:
    """The Galois lane's result from the un-permuted [k, B, 2, n] sums:
    element b's sums gathered by phi_{g_b} in the NTT domain, one inverse,
    and phi_{g_b}(c0_b) added to row 0 (c0 [k, B, n])."""
    out = _inverse_pairs(_gathered(acc, elements), tb)
    n = acc.shape[-1]
    hs = tuple(pow(int(g), -1, 2 * n) for g in elements)
    rot = _galois.automorphism_fused(c0[:, None], hs, tb.p)[:, 0]   # [k, B, n]
    return torch.stack([mm.add_mod(out[:, 0], rot, tb.p.view(-1, 1, 1)), out[:, 1]], dim=1)


def _per_element(c0: torch.Tensor, batch: int, k: int, n: int) -> torch.Tensor:
    """c0 [k, n] (shared) or [k, S, n] (one per digit stack) as [k, batch, n]
    rows, stack s serving batch / S consecutive elements."""
    if c0.dim() == 2:
        return c0[:, None].expand(k, batch, n)
    return c0.repeat_interleave(batch // c0.shape[1], dim=1)


def ks_inner_batch(dg: torch.Tensor, keys: torch.Tensor,
                   tb: NTTTables, elements=None,
                   c0: torch.Tensor | None = None) -> torch.Tensor:
    """INTT(sum_j dg[i, j, b_dg] ⊙ keys[i, j, b, c]) for c = 0, 1 and each of
    B elements: dg the [k, kd, B_dg, n] NTT-domain digit stacks, B_dg = B
    (one per element) or 1 (one stack shared by every element, b_dg = 0);
    keys the per-element [k, kd, B, 2, n] NTT-form key material.  Returns
    the [k, 2, B, n] coefficient-domain corrections.

    With the B Galois ``elements`` and c0 ([k, n] shared, or [k, B, n]) (the
    Galois lane; keys pre-permuted as ``hoisted_galois_keys`` makes them):
    element b is phi_{g_b}(correction + (c0, 0)), computed the kernel's way,
    by the gather of the NTT-domain sums before the inverse."""
    prod = mm.mul_mod(dg[:, :, :, None], keys, _p(tb, 5))      # [k, kd, B, 2, n]
    acc = prod.to(torch.int64).sum(1)
    if elements is None:
        return _inverse_pairs(acc, tb)
    k, n, batch = dg.shape[0], dg.shape[-1], keys.shape[2]
    return _galois_rows(acc, tb, elements, _per_element(c0, batch, k, n))


def ks_inner_grouped(dg: torch.Tensor, keys: torch.Tensor,
                     tb: NTTTables, elements=None,
                     c0: torch.Tensor | None = None) -> torch.Tensor:
    """``ks_inner_batch`` of C digit stacks dg [k, kd, C, n] against E key
    sets keys [k, kd, E, 2, n]: element b = c*E + e pairs stack c with key
    set e.  Returns [k, 2, C*E, n].  With the E Galois ``elements`` and c0
    [k, C, n] (the Galois lane): element c*E + e is
    phi_{g_e}(correction + (c0_c, 0))."""
    k, kd, num_c, n = dg.shape
    num_e = keys.shape[2]
    prod = mm.mul_mod(dg[:, :, :, None, None], keys[:, :, None], _p(tb, 6))
    acc = prod.to(torch.int64).sum(1).view(k, num_c * num_e, 2, n)
    if elements is None:
        return _inverse_pairs(acc, tb)
    return _galois_rows(acc, tb, tuple(elements) * num_c,
                        _per_element(c0, num_c * num_e, k, n))
