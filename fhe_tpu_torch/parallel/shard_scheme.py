"""Explicit BEHZ multiply + relinearize over the RNS prime axis —
counterpart of ``fhe_tpu/parallel/shard_scheme.py``.

Every cross-prime data movement is a named collective of ``mesh.py``, so the
communication is exact and counted.  The JAX package runs this as one
``shard_map`` program; here every rank of the mesh axis ``rns`` (P ranks,
k - L primes at level L) runs the same function on the whole ciphertexts
and keys, takes its own rows and returns the whole result.

Data layout (rank r of P holds rows [r*m, (r+1)*m) of each):

  * q-base residue tensors ``[k, c, n]``     -> rows split, (k - L) % P == 0
  * Bsk-base tensors ``[kb, c, n]``          -> rows padded to kb_pad =
    ceil(kb/P)*P by repeating the m_sk row (padded rows compute valid but
    unused arithmetic), then split
  * key material ``[k_prime, k_digit, 2, n]`` -> prime axis split
  * NTT tables                               -> prime rows split (row views)

Collectives per multiply + relinearize (the full inventory — nothing else
moves):

  1. ``all_gather`` of the SmMRq digits of both operands   [k, 4, n]
  2. ``all_gather`` of the FastFloor conversion digits     [k, 3, n]
  3. ``all_gather`` of the floored Bsk rows (Shenoy-K.)    [kb_pad, 3, n]
  4. ``all_gather`` of the relinearization gadget digits   [k, n]

and ``assemble``, the one all-gather that gives every rank the result.  The
per-prime tensor products run on each rank's rows through
``ntt_cuda.tensor_product`` (the t-folded tables of the level), the key
switch through ``ntt_cuda.keyswitch_fused`` on the gathered digits against
the rank's key rows; on CPU tensors the wrappers run their plain versions.
The base-conversion steps between them are elementwise torch ops with exact
int64 products, as in ``ops/rns.py``.  ``keyswitch_delta_psum`` reduces the
key-switch inner product with an exact modular all-reduce instead (2x the
collective bytes, full tables on every rank): the measured counterpoint.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ops import modmath as mm
from ..ops import ntt as _ntt
from ..ops import ntt_cuda
from ..ops.rns import _col
from ..scheme import noise as _noise
from ..scheme.types import Ciphertext, RelinKeys
from . import mesh as _mesh

_MASK16 = 0xFFFF


# ---------------------------------------------------------------------------
# constant bundles (the level's constants, Bsk rows padded to kb_pad)
# ---------------------------------------------------------------------------


class _QConsts(NamedTuple):
    """Per-q-prime constants: every leaf has leading dim k - L."""

    p: torch.Tensor               # [k]   the level's q primes
    mt_inv_phat: torch.Tensor     # [k]   SmMRq digit scale (m_tilde folded)
    floor_inv_phat: torch.Tensor  # [k]   FastFloor conv digit scale
    inv_qhat: torch.Tensor        # [k]   relin gadget digit scale
    sk_phat: torch.Tensor         # [k, l]  (B/b_i) mod q_j   (SK -> q rows)
    sk_bmod: torch.Tensor         # [k]   B mod q_j


class _BskConsts(NamedTuple):
    """Per-Bsk-prime constants, padded to kb_pad rows."""

    p: torch.Tensor               # [kb_pad]
    smq_phat: torch.Tensor        # [kb_pad, k]  (q/q_i) mod c_j
    smq_qmod: torch.Tensor        # [kb_pad]  q mod c_j
    smq_inv_mt: torch.Tensor      # [kb_pad]  m_tilde^-1 mod c_j
    floor_phat: torch.Tensor      # [kb_pad, k]
    floor_inv_q: torch.Tensor     # [kb_pad]  q^-1 mod c_j


def _pad_rows(arr: torch.Tensor, rows: int) -> torch.Tensor:
    """Pad the leading axis to `rows` by repeating the last row (the m_sk
    row): padded rows run valid modular arithmetic whose results are
    discarded after the gather; every rank needs blocks of one size."""
    pad = rows - arr.shape[0]
    if pad == 0:
        return arr
    return torch.cat([arr] + [arr[-1:]] * pad, dim=0)


def _pad_tables(tb: _ntt.NTTTables, rows: int) -> _ntt.NTTTables:
    return dataclasses.replace(tb, **{f: _pad_rows(getattr(tb, f), rows) for f in _ntt.FIELDS},
                               primes=tb.primes + tb.primes[-1:] * (rows - tb.k))


def _row_tables(tb: _ntt.NTTTables, start: int, rows: int) -> _ntt.NTTTables:
    """Zero-copy view of rows [start, start + rows) of tb."""
    return _ntt.slice_tables(_ntt.slice_tables_last(tb, tb.k - start), rows)


def build_plan(ctx, n_devices: int, level: int = 0) -> dict:
    """The constant bundles and tables of one level over ``n_devices``
    ranks: q constants, Bsk constants padded to kb_pad rows, the level's
    t-folded q and Bsk tables (``ctx.mul_levels[level]``, Bsk padded) for
    the tensor products and its plain q tables for the key switch.  A
    rank's rows are row views of them.  Cached per (n_devices, level) on
    the context object."""
    cache = getattr(ctx, "_shard_plan_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(ctx, "_shard_plan_cache", cache)
    if (n_devices, level) in cache:
        return cache[(n_devices, level)]
    kk = ctx.k - level
    if kk % n_devices:
        raise ValueError(
            f"explicit rns sharding needs (k - level) % P == 0 "
            f"(k={ctx.k}, level={level}, P={n_devices})")
    kb = ctx.bsk_counts[level]
    kb_pad = -(-kb // n_devices) * n_devices
    smq = ctx.smq_levels[level]
    fc = ctx.floor_levels[level]
    skc = ctx.sk_levels[level]
    tq, tbsk = ctx.mul_levels[level]

    qc = _QConsts(p=tq.p, mt_inv_phat=smq.mt_times_inv_phat,
                  floor_inv_phat=fc.conv.inv_phat, inv_qhat=ctx.inv_qhat_levels[level],
                  sk_phat=skc.conv_q.phat_mod_dst, sk_bmod=skc.B_mod_q)
    bc = _BskConsts(*(_pad_rows(x, kb_pad) for x in (
        smq.conv.p_dst, smq.conv.phat_mod_dst, smq.q_mod_dst, smq.inv_mt_dst,
        fc.conv.phat_mod_dst, fc.inv_q_dst)))
    plan = dict(kb=kb, kb_pad=kb_pad, qc=qc, bc=bc, tq=tq, tbsk=_pad_tables(tbsk, kb_pad),
                tb_q=_ntt.slice_tables(ctx.ntt_q, kk))
    cache[(n_devices, level)] = plan
    return plan


# ---------------------------------------------------------------------------
# local building blocks (each rank's rows; exact int64 products)
# ---------------------------------------------------------------------------


def _mulp(x: torch.Tensor, w: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """x * w mod p per row: x [m, ...], w and p [m]; int64."""
    return x.to(torch.int64) * _col(w, x.dim()) % _col(p, x.dim())


def _accum_rows(y_full: torch.Tensor, phat_loc: torch.Tensor,
                p_loc: torch.Tensor) -> torch.Tensor:
    """sum_i y_i * (P/p_i) mod c_j for this rank's dst rows.

    y_full [k, c, n] (gathered digits), phat_loc [kl, k], p_loc [kl]."""
    p4 = _col(p_loc, 4)
    terms = y_full.to(torch.int64)[None] * phat_loc.to(torch.int64)[:, :, None, None] % p4
    return terms.sum(1) % _col(p_loc)


def _alpha_mtilde(y_full: torch.Tensor, phat_mod_mt: torch.Tensor,
                  inv_q_mt: int) -> torch.Tensor:
    """The SmMRq m_tilde-lane correction, replicated (cheap [c, n] work):
    the JAX package's uint32 sums taken mod 2^16, here in int64, where the
    sum of k 32-bit products cannot wrap."""
    lane = ((y_full.to(torch.int64) & _MASK16) * _col(phat_mod_mt)).sum(0) & _MASK16
    return (lane * inv_q_mt) & _MASK16


# ---------------------------------------------------------------------------
# the explicit multiply + relinearize
# ---------------------------------------------------------------------------


def multiply_relin_shardmap(ctx, a: Ciphertext, b: Ciphertext,
                            rlk: RelinKeys, mesh,
                            axis: str = "rns",
                            keys_at_level: bool = False) -> Ciphertext:
    """BEHZ multiply + relinearize with every cross-prime exchange an
    explicit collective (module docstring), run by every rank of ``mesh``
    along ``axis`` on the whole a, b and rlk; every rank returns the whole
    result.  Any level with (k - level) % P == 0 (level-0 keys are
    switched down unless keys_at_level); bit-exact with scheme.bfv.multiply
    (tests/test_torch_parallel.py)."""
    if a.level != b.level:
        raise ValueError("operands must share a level")
    from ..scheme.bfv import _omega as _ks_omega
    if _ks_omega(ctx) > 1:
        raise ValueError(
            "the explicit sharded multiply builds per-prime gadget "
            "digits; grouped-gadget keys (ks_omega > 1) are not supported "
            "here — use ks_omega=1 parameters for the distributed path")
    level = a.level
    from ..scheme import bfv as _bfv
    a = _bfv.to_coeff(ctx, a)
    b = _bfv.to_coeff(ctx, b)
    n_dev = _mesh.axis_size(mesh, axis)
    plan = build_plan(ctx, n_dev, level)
    keys = (rlk.data if keys_at_level
            else _bfv._switch_keys_down(ctx, rlk.data, level, False))
    keys_t = keys.permute(1, 0, 2, 3)                 # [k_prime, kd, 2, n]

    out = _local_multiply(ctx, plan, a.data, b.data, keys_t, mesh, axis, level)
    v3 = _noise.bfv_multiply(ctx.params, _bfv._v_of(ctx, a),
                             _bfv._v_of(ctx, b))
    bud = _bfv._b_of(ctx, level, _noise.add(
        _noise.bfv_variance(ctx.params, level, _bfv._b_of(ctx, level, v3)),
        _noise.keyswitch_add(ctx.params, level)))
    return Ciphertext(data=out, level=level, is_ntt_form=False,
                      noise_budget=bud)


def _local_multiply(ctx, plan: dict, a: torch.Tensor, b: torch.Tensor,
                    keys_t: torch.Tensor, mesh, axis: str, level: int) -> torch.Tensor:
    """One rank's part of the multiply (JAX's shard_map body) on its rows
    of the whole [k, 2, n] a, b and [k, kd, 2, n] keys_t; returns the whole
    [k, 2, n] result."""
    n_dev = _mesh.axis_size(mesh, axis)
    r = _mesh.axis_index(mesh, axis)
    kl = (ctx.k - level) // n_dev
    kbl = plan["kb_pad"] // n_dev
    kb = plan["kb"]
    q_rows = _mesh.rns_sharding(mesh, 1, axis).local
    qc = _QConsts(*(q_rows(x) for x in plan["qc"]))
    bc = _BskConsts(*(q_rows(x) for x in plan["bc"]))
    tq_loc = _row_tables(plan["tq"], r * kl, kl)         # t-folded: t * product
    tbsk_loc = _row_tables(plan["tbsk"], r * kbl, kbl)
    tb_loc = _row_tables(plan["tb_q"], r * kl, kl)       # plain: the key switch
    smq = ctx.smq_levels[level]
    skc = ctx.sk_levels[level]
    a_loc, b_loc, keys_loc = q_rows(a), q_rows(b), q_rows(keys_t)
    p_loc, pb_loc = _col(qc.p), _col(bc.p)

    # ---- SmMRq lift of both operands: digits -> all_gather -> local Bsk
    # rows + replicated m_tilde correction ----
    ab = torch.cat([a_loc, b_loc], dim=1)                       # [kl, 4, n]
    y_loc = _mulp(ab, qc.mt_inv_phat, qc.p).to(torch.int32)
    y_full = _mesh.all_gather(y_loc, mesh, axis)                # [k, 4, n]
    conv = _accum_rows(y_full, bc.smq_phat, bc.p)
    alpha = _alpha_mtilde(y_full, smq.phat_mod_mt, smq.inv_q_mt)[None]
    alpha_mod = torch.where(alpha < (1 << 15), alpha, pb_loc - ((1 << 16) - alpha))
    aq = alpha_mod * _col(bc.smq_qmod) % pb_loc
    lift = ((conv - aq) % pb_loc * _col(bc.smq_inv_mt) % pb_loc).to(torch.int32)  # [kbl, 4, n]

    # ---- tensor products in both bases (rank-local NTTs), t-scaled ----
    tx_q = ntt_cuda.tensor_product(a_loc, b_loc, tq_loc)               # [kl, 3, n]
    tx_bsk = ntt_cuda.tensor_product(lift[:, :2], lift[:, 2:], tbsk_loc)  # [kbl, 3, n]

    # ---- FastFloor: conv digits -> all_gather -> local Bsk rows ----
    y2_loc = _mulp(tx_q, qc.floor_inv_phat, qc.p).to(torch.int32)
    y2_full = _mesh.all_gather(y2_loc, mesh, axis)              # [k, 3, n]
    conv2 = _accum_rows(y2_full, bc.floor_phat, bc.p)
    floored = ((tx_bsk.to(torch.int64) - conv2) % pb_loc * _col(bc.floor_inv_q)
               % pb_loc).to(torch.int32)                        # [kbl, 3, n]

    # ---- Shenoy-Kumaresan exact Bsk -> q: gather the (padded) Bsk rows,
    # convert to this rank's q rows ----
    fl_full = _mesh.all_gather(floored, mesh, axis)             # [kb_pad, 3, n]
    x_aux = fl_full[:kb - 1]                                    # [l, 3, n]
    x_msk = fl_full[kb - 1]                                     # [3, n]
    y3 = _mulp(x_aux, skc.conv_q.inv_phat, skc.conv_q.p_src)
    conv_q = _accum_rows(y3, qc.sk_phat, qc.p)
    # m_sk lane + centered alpha (replicated [3, n] work)
    m_sk = skc.m_sk
    conv_sk = (y3 * _col(skc.conv_sk.phat_mod_dst[0]) % m_sk).sum(0) % m_sk
    alpha_sk = (conv_sk - x_msk) % m_sk * skc.inv_B_sk % m_sk
    alpha_q = torch.where(alpha_sk <= m_sk >> 1, alpha_sk, p_loc - (m_sk - alpha_sk))
    out3 = (conv_q - alpha_q * _col(qc.sk_bmod) % p_loc) % p_loc  # [kl, 3, n]

    # ---- relinearize: gadget digits -> all_gather -> local fused key
    # switch on this rank's prime rows ----
    d_loc = (out3[:, 2] * _col(qc.inv_qhat, 2) % _col(qc.p, 2)).to(torch.int32)  # [kl, n]
    d_full = _mesh.all_gather(d_loc, mesh, axis)                # [k, n]
    delta = ntt_cuda.keyswitch_fused(d_full, keys_loc, tb_loc)  # [kl, 2, n]
    out = mm.add_mod(out3[:, :2].to(torch.int32), delta, _col(qc.p).to(torch.int32))
    return _mesh.assemble(out, mesh, axis)


# ---------------------------------------------------------------------------
# psum-strategy key switch (collective-cost comparison; see module docstring)
# ---------------------------------------------------------------------------


def psum_mod(x: torch.Tensor, p, p_sh16, mesh, axis: str) -> torch.Tensor:
    """Exact modular all-reduce over ``axis`` of per-rank partials in
    [0, p), p < 2^30.

    A 32-bit sum would overflow at P >= 4 terms, so the value is split into
    16-bit halves (each sum < P * 2^16, within int32), then recombined as
    hi * 2^16 + lo mod p through one Shoup multiply.  p_sh16 is the Shoup
    companion of 2^16 mod p.  Two all-reduces of the tensor."""
    hi = _mesh.psum(x >> 16, mesh, axis)
    lo = _mesh.psum(x & _MASK16, mesh, axis)
    p64 = mm._u32(p)
    return mm.add_mod(mm.mul_mod_shoup(hi, 1 << 16, p_sh16, p64), lo.to(torch.int64),
                      p64).to(torch.int32)


def keyswitch_delta_psum(ctx, poly: torch.Tensor, ks_keys: torch.Tensor,
                         mesh, axis: str = "rns") -> torch.Tensor:
    """Key-switch correction with the inner product reduced by an exact
    modular all-reduce: rank j holds gadget digit rows j (keys digit-major
    split), computes NTT_i(D_j) * key_{j,i} partials for ALL primes i
    (``ntt_cuda.ntt_forward`` over the full tables), and the digit-axis sum
    becomes ``psum_mod``; each rank then transforms its prime rows back
    (``ntt_cuda.ntt_inverse``).  2x the collective bytes and k x the table
    memory of the gather strategy in multiply_relin_shardmap; kept as the
    measured counterpoint.

    poly [k, n] coeff domain; ks_keys [kd, k, 2, n] digit-major; every rank
    passes the whole of both.  Returns the whole [k, 2, n] coeff-domain
    delta on every rank, bit-exact with the single-device inner product."""
    k = ctx.k
    n_dev = _mesh.axis_size(mesh, axis)
    if k % n_dev:
        raise ValueError(f"k % P != 0 (k={k}, P={n_dev})")
    tb = ctx.ntt_q
    sh16 = mm.u32_tensor(mm.shoup_array([1 << 16] * k, tb.primes), tb.device)
    rows = _mesh.rns_sharding(mesh, 1, axis).local
    # digit scaling is elementwise per digit row: each rank scales its own
    d_loc = _mulp(rows(poly), rows(ctx.inv_qhat_levels[0]), rows(tb.p))     # [kdl, n]
    dr = torch.remainder(d_loc[None], _col(tb.p)).to(torch.int32)          # [k, kdl, n]
    f = ntt_cuda.ntt_forward(dr, tb)                                        # [k, kdl, n]
    prod = mm.mul_mod(f[:, :, None], rows(ks_keys).permute(1, 0, 2, 3), _col(tb.p, 4))
    partial = (prod.to(torch.int64).sum(1) % _col(tb.p)).to(torch.int32)   # [k, 2, n]
    acc = psum_mod(partial, _col(tb.p), _col(sh16), mesh, axis)
    kl = k // n_dev
    r = _mesh.axis_index(mesh, axis)
    out = ntt_cuda.ntt_inverse(rows(acc).contiguous(), _row_tables(tb, r * kl, kl))
    return _mesh.assemble(out, mesh, axis)
