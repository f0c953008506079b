"""Distributed negacyclic NTT over coefficient blocks — counterpart of
``fhe_tpu/parallel/distributed_ntt.py``.

Scales polynomial degree n beyond one device: the coefficient axis is
block-split over a ``coeff`` mesh axis of P ranks, each holding L = n/P
coefficients.  In the merged-psi CT stage loop (ops/ntt.py), a stage with m
groups pairs elements at stride t = n/(2m):

  * stages m = 1 .. P/2  — the partner lives on another rank at the *same
    local offset*; each stage is one pairwise block exchange
    (``mesh.exchange``, a ``batch_isend_irecv`` pair) + a full-width local
    butterfly.  log2(P) exchange stages in all, each moving one block.
  * stages m = P .. n/2  — entirely rank-local; the single-device stages
    with per-rank twiddle slices, which start at m + s*g for rank s and g
    groups per rank.

The inverse transform mirrors it (local GS stages first, then the exchange
stages, then the n^-1 scale).  Where the JAX code calls these inside
``shard_map`` and names the axis, the port takes the mesh and axis: every
rank calls the transforms on its own [k, B, L] block.  The JAX package
computes this module in jnp, with no Pallas kernel; the port computes it in
torch ops with exact int64 products, on the block's device.  Bit-exact with
ops/ntt.py on the gathered result (tests/test_torch_dist_ntt.py).
"""

from __future__ import annotations

import torch

from ..ops import modmath as mm
from ..ops.ntt import NTTTables
from ..ops.rns import _col
from . import mesh as _mesh


def _pair_perm(P_: int, offset: int) -> list[tuple[int, int]]:
    """Full pairwise exchange permutation: s <-> s +- offset within groups."""
    perm = []
    for s in range(P_):
        pos = s % (2 * offset)
        partner = s + offset if pos < offset else s - offset
        perm.append((s, partner))
    return perm


def _fwd_local_stages(a: torch.Tensor, tb: NTTTables, n: int, m0: int, s: int) -> torch.Tensor:
    """CT stages m = m0 .. n/2 on a local [k, B, L] block of rank s (int64)."""
    k, b, L = a.shape
    p4 = _col(tb.p, 4)
    m = m0
    while m < n:
        t = n // (2 * m)
        g = (m * L) // n  # groups fully inside this block
        w = tb.psi_br[:, m + s * g:m + s * g + g].to(torch.int64)[:, None, :, None]
        x = a.reshape(k, b, g, 2, t)
        u = x[:, :, :, 0, :]
        v = x[:, :, :, 1, :] * w % p4
        a = torch.stack((mm.add_mod(u, v, p4), mm.sub_mod(u, v, p4)),
                        dim=3).reshape(k, b, L)
        m *= 2
    return a


def _inv_local_stages(a: torch.Tensor, tb: NTTTables, n: int, m_stop: int,
                      s: int) -> torch.Tensor:
    """GS stages m = n/2 down to m_stop on a local [k, B, L] block (int64)."""
    k, b, L = a.shape
    p4 = _col(tb.p, 4)
    m = n // 2
    while m >= m_stop:
        t = n // (2 * m)
        g = (m * L) // n
        w = tb.ipsi_br[:, m + s * g:m + s * g + g].to(torch.int64)[:, None, :, None]
        x = a.reshape(k, b, g, 2, t)
        u = x[:, :, :, 0, :]
        v = x[:, :, :, 1, :]
        a = torch.stack((mm.add_mod(u, v, p4), mm.sub_mod(u, v, p4) * w % p4),
                        dim=3).reshape(k, b, L)
        m //= 2
    return a


def _check_shards(num_shards: int):
    if num_shards & (num_shards - 1):
        raise ValueError(
            f"coeff axis size must be a power of two (got {num_shards}): "
            "cross-shard butterfly pairing assumes power-of-two strides")


def _check_mesh(mesh, axis: str, num_shards: int) -> int:
    """Raise unless num_shards is a power of two and the axis's size; return
    this rank's coordinate on it."""
    _check_shards(num_shards)
    if _mesh.axis_size(mesh, axis) != num_shards:
        raise ValueError(f"num_shards={num_shards}, but mesh axis {axis!r} has "
                         f"{_mesh.axis_size(mesh, axis)} ranks")
    return _mesh.axis_index(mesh, axis)


def dist_ntt_forward(a_local: torch.Tensor, tb: NTTTables, n: int, num_shards: int,
                     mesh, axis: str = "coeff") -> torch.Tensor:
    """Forward NTT of this rank's block [k, B, n/P] of block-split
    residues; returns the rank's block of the bit-reversed result."""
    s = _check_mesh(mesh, axis, num_shards)
    p3 = _col(tb.p, 3)
    a_local = a_local.to(torch.int32)
    m = 1
    # cross-shard exchange stages (blocks travel as int32 words)
    while m <= num_shards // 2:
        offset = num_shards // (2 * m)
        group = s * m // num_shards
        w = _col(tb.psi_br[:, m + group], 3)
        other = _mesh.exchange(a_local, mesh, axis, _pair_perm(num_shards, offset)[s][1])
        mine, other = a_local.to(torch.int64), other.to(torch.int64)
        if (s % (2 * offset)) < offset:
            a_local = mm.add_mod(mine, other * w % p3, p3)      # U + w*V  (I hold U)
        else:
            a_local = mm.sub_mod(other, mine * w % p3, p3)      # U - w*V  (I hold V)
        a_local = a_local.to(torch.int32)
        m *= 2
    # local stages
    return _fwd_local_stages(a_local.to(torch.int64), tb, n, m, s).to(torch.int32)


def dist_ntt_inverse(a_local: torch.Tensor, tb: NTTTables, n: int, num_shards: int,
                     mesh, axis: str = "coeff") -> torch.Tensor:
    """Inverse NTT of this rank's block [k, B, n/P] of bit-reversed
    residues, times n^-1; returns the rank's block of the natural-order
    result."""
    s = _check_mesh(mesh, axis, num_shards)
    p3 = _col(tb.p, 3)
    # local GS stages first (m = n/2 .. P)
    a_local = _inv_local_stages(a_local.to(torch.int64), tb, n, num_shards, s)
    # cross-shard stages m = P/2 .. 1 (blocks travel as int32 words)
    m = num_shards // 2
    while m >= 1:
        offset = num_shards // (2 * m)
        group = s * m // num_shards
        w = _col(tb.ipsi_br[:, m + group], 3)
        other = _mesh.exchange(a_local.to(torch.int32), mesh, axis,
                               _pair_perm(num_shards, offset)[s][1]).to(torch.int64)
        if (s % (2 * offset)) < offset:
            a_local = mm.add_mod(a_local, other, p3)              # U' = U + V
        else:
            a_local = mm.sub_mod(other, a_local, p3) * w % p3     # V' = (U - V) * w
        m //= 2
    return (a_local * _col(tb.n_inv, 3) % p3).to(torch.int32)


def make_distributed_polymul(mesh, tb: NTTTables, n: int, axis: str = "coeff"):
    """Distributed negacyclic polymul over a coefficient-split mesh.

    Returns f(a, b) for the whole [k, B, n] inputs, which every rank of the
    mesh calls: each transforms its block, and f returns the whole
    product on every rank."""
    num_shards = _mesh.axis_size(mesh, axis)
    _check_shards(num_shards)
    blocks = _mesh.Sharding(mesh, (None, None, axis))

    def f(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        fa = dist_ntt_forward(blocks.local(a), tb, n, num_shards, mesh, axis)
        fb = dist_ntt_forward(blocks.local(b), tb, n, num_shards, mesh, axis)
        prod = mm.mul_mod(fa, fb, _col(tb.p, 3))
        out = dist_ntt_inverse(prod, tb, n, num_shards, mesh, axis)
        return _mesh.assemble(out, mesh, axis, dim=2)
    return f


# ---------------------------------------------------------------------------
# scheme-level coefficient-sharded multiply + relinearize
# ---------------------------------------------------------------------------


def _tensor_dist(x, y, tb, n, num_shards, mesh, axis):
    """(x ⊗ y) on coeff-split [k, 2, L] blocks -> [k, 3, L]; with the
    multiply's t-folded tables (n^-1 -> t * n^-1) it is t * (x ⊗ y), the
    JAX package's explicit scale by t."""
    f = dist_ntt_forward(torch.cat([x, y], dim=1), tb, n, num_shards, mesh, axis)
    xf, yf = f[:, :2], f[:, 2:]
    p = _col(tb.p, 3)
    c0 = mm.mul_mod(xf[:, :1], yf[:, :1], p)
    c2 = mm.mul_mod(xf[:, 1:], yf[:, 1:], p)
    c1 = mm.add_mod(mm.mul_mod(xf[:, :1], yf[:, 1:], p),
                    mm.mul_mod(xf[:, 1:], yf[:, :1], p), p)
    return dist_ntt_inverse(torch.cat([c0, c1, c2], dim=1), tb, n, num_shards, mesh, axis)


def multiply_relin_coeff_sharded(ctx, a, b, rlk, mesh, axis: str = "coeff"):
    """Full BEHZ multiply + relinearize with the COEFFICIENT axis split —
    ring degrees beyond one device.  Every rank of ``mesh`` along ``axis``
    calls it on the whole a, b and rlk and gets the whole result.

    Every BEHZ base conversion (SmMRq / FastFloor / Shenoy-Kumaresan) and
    the key-switch inner product are POINTWISE per coefficient, so they run
    rank-local (``ops/rns.py``'s plain conversions on the rank's block)
    with zero communication; the only cross-rank traffic is the log2(P)
    exchange stages inside each distributed NTT, and ``assemble`` of the
    result.  Level-0 ciphertexts; bit-exact with bfv.multiply
    (tests/test_torch_dist_ntt.py)."""
    from ..ops import rns as _rns
    from ..scheme import bfv as _bfv
    from ..scheme import noise as _noise
    from ..scheme.types import Ciphertext

    if a.level or b.level:
        raise ValueError("coeff-sharded multiply covers level 0")
    a = _bfv.to_coeff(ctx, a)
    b = _bfv.to_coeff(ctx, b)
    n = ctx.n
    num_shards = _mesh.axis_size(mesh, axis)
    _check_shards(num_shards)
    smq = ctx.smq_levels[0]
    fc = ctx.floor_levels[0]
    skc = ctx.sk_levels[0]
    inv_qhat = ctx.inv_qhat_levels[0]
    tb_q = ctx.ntt_q
    tq, tbsk = ctx.mul_levels[0]                     # t-folded: t * product
    keys_t = rlk.data.permute(1, 0, 2, 3)            # [k_prime, kd, 2, n]
    blocks = _mesh.Sharding(mesh, (None, None, axis))
    a_loc, b_loc = blocks.local(a.data), blocks.local(b.data)
    keys_loc = _mesh.Sharding(mesh, (None, None, None, axis)).local(keys_t)
    p3, p4 = _col(tb_q.p, 3), _col(tb_q.p, 4)

    # BEHZ conversions: pointwise per coefficient -> the single-device rns
    # code runs unchanged on the local block
    lift_a = _rns.sm_mrq(a_loc, smq)
    lift_b = _rns.sm_mrq(b_loc, smq)
    tx_q = _tensor_dist(a_loc, b_loc, tq, n, num_shards, mesh, axis)
    tx_bsk = _tensor_dist(lift_a, lift_b, tbsk, n, num_shards, mesh, axis)
    floored = _rns.fast_floor(tx_q, tx_bsk, fc)
    out3 = _rns.fast_bconv_sk(floored, skc)          # [k, 3, L]
    # key switch: digit scale + per-prime reduce are elementwise; the two
    # transforms are distributed; the inner product is pointwise-local
    d = out3[:, 2].to(torch.int64) * _col(inv_qhat, 2) % _col(tb_q.p, 2)
    d_all = d[None] % p3                             # [k, kd, L]
    f = dist_ntt_forward(d_all, tb_q, n, num_shards, mesh, axis)
    prod = mm.mul_mod(f[:, :, None, :], keys_loc, p4)
    acc = prod.to(torch.int64).sum(1) % p3           # [k, 2, L]
    delta = dist_ntt_inverse(acc, tb_q, n, num_shards, mesh, axis)
    out = _mesh.assemble(mm.add_mod(out3[:, :2], delta, p3.to(torch.int32)), mesh, axis, dim=2)
    v3 = _noise.bfv_multiply(ctx.params, _bfv._v_of(ctx, a),
                             _bfv._v_of(ctx, b))
    bud = _bfv._b_of(ctx, 0, _noise.add(
        v3, _noise.keyswitch_add(ctx.params, 0)))
    return Ciphertext(data=out, level=0, is_ntt_form=False,
                      noise_budget=bud)
