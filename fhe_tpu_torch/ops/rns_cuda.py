"""BEHZ conversion kernel wrappers — counterpart of ``fhe_tpu/ops/rns_pallas.py``.

``bsk_branch_fused`` (and ``bsk_branch_fused_batch``, the same kernel with
a batch grid axis), ``fast_bconv_sk_fused``, and the n < 1024 multiply's
``sm_mrq_fused`` and ``fast_floor_fused`` launch the hand-written CUDA
kernels of ``csrc/rns.cu`` (design and bound: the note at the top of that
file) for CUDA tensors and use the plain PyTorch versions of ``ops/rns.py``
(``bsk_branch_fused``, ``bsk_branch_fused_batch``, ``fast_bconv_sk``,
``sm_mrq``, ``fast_floor``) for CPU tensors; any other device raises.  Each
wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import rns as _rns
from .ntt import NTTTables
from .ntt_cuda import (check_aligned_tables, check_barrett, check_views,
                       log2_exact, on_card, table_ptrs, tensor_product_geometry)

_P = ctypes.c_void_p
_U = ctypes.c_uint32
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("rns")
    lib.fhe_bsk_branch.argtypes = ([_P] + [_I] * 3 + [_P] + [_I] * 3 + [_P] * 11
                                   + [_U] + [_P] * 14 + [_I] * 6 + [_P])
    lib.fhe_fast_bconv_sk.argtypes = ([_P] * 12 + [_U] * 3 + [_I] * 2 + [_L]
                                      + [_P])
    lib.fhe_sm_mrq.argtypes = [_P] * 13 + [_U] + [_I] * 3 + [_P]
    lib.fhe_fast_floor.argtypes = [_P] * 11 + [_I] * 3 + [_P]
    for f in (lib.fhe_bsk_branch, lib.fhe_fast_bconv_sk, lib.fhe_sm_mrq,
              lib.fhe_fast_floor):
        f.restype = ctypes.c_int
    return lib


def _check_int32(x: torch.Tensor, shape: tuple, name: str) -> None:
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 residues, got {x.dtype}")
    if tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {list(shape)} tensor, "
                         f"got {list(x.shape)}")


def _check_bsk_consts(sc: _rns.SmMRqConsts, fc: _rns.FastFloorConsts,
                      tb_bsk: NTTTables, ab: torch.Tensor, tx_q: torch.Tensor,
                      name: str) -> None:
    if sc.conv.p_dst.shape[0] != tb_bsk.k or fc.conv.p_dst.shape[0] != tb_bsk.k:
        raise ValueError(f"{name}: constants do not match the tables")
    if not (ab.device == tx_q.device == tb_bsk.device == sc.conv.p_src.device
            == fc.inv_q_dst.device):
        raise ValueError(f"{name}: tensors on different devices")


def bsk_branch_geometry(n: int, kb: int, batch: int = 1) -> dict:
    """Launch shape of ``bsk_branch_fused`` for B = ``batch`` elements and
    kb Bsk primes: the cluster tensor product of ``tensor_product`` (8 CTAs
    per (element, Bsk prime), two per input row, which share the row's lift
    and forward transform and, for rows 0 to 2, its product row's inverse
    transform and floor; two padded rows of shared memory per CTA).  Raise
    where that does not fit the card."""
    return tensor_product_geometry(n, kb, batch, "bsk_branch_fused")


def _bsk_branch_launch(ab: torch.Tensor, tx_q: torch.Tensor,
                       sc: _rns.SmMRqConsts, fc: _rns.FastFloorConsts,
                       tb_bsk: NTTTables, name: str) -> torch.Tensor:
    """One launch over ab [k, 4, B, n] and tx_q [k, 3, B, n] (strided, rows
    of n contiguous): the floored [kb, 3, B, n]."""
    k, _, batch, n = ab.shape
    kb = tb_bsk.k
    check_barrett(tb_bsk, name)
    check_aligned_tables(tb_bsk, name)
    geo = bsk_branch_geometry(n, kb, batch)
    for x in (ab, tx_q):                   # the kernel indexes with 32-bit strides
        if sum((d - 1) * st for d, st in zip(x.shape, x.stride())) >= 1 << 31:
            raise ValueError(f"{name}: tensor too large for 32-bit offsets")
    out = torch.empty((kb, 3, batch, n), dtype=torch.int32, device=ab.device)
    p = _build.ptr
    _build.launch(
        _lib().fhe_bsk_branch, name, ab.device,
        p(ab), *ab.stride()[:3], p(tx_q), *tx_q.stride()[:3], p(out),
        p(sc.conv.p_src), p(sc.mt_times_inv_phat),
        p(sc.mt_times_inv_phat_shoup), p(sc.conv.phat_mod_dst),
        p(sc.conv.phat_shoup_dst), p(sc.phat_mod_mt), p(sc.q_mod_dst),
        p(sc.q_shoup_dst), p(sc.inv_mt_dst), p(sc.inv_mt_shoup_dst),
        sc.inv_q_mt, p(fc.conv.inv_phat), p(fc.conv.inv_phat_shoup),
        p(fc.conv.phat_mod_dst), p(fc.conv.phat_shoup_dst), p(fc.inv_q_dst),
        p(fc.inv_q_shoup_dst), *table_ptrs(tb_bsk), k, kb, batch, log2_exact(n),
        geo["threads"], geo["smem"])
    return out


def bsk_branch_fused(ab: torch.Tensor, tx_q: torch.Tensor,
                     sc: _rns.SmMRqConsts, fc: _rns.FastFloorConsts,
                     tb_bsk: NTTTables) -> torch.Tensor:
    """The multiply's Bsk branch in one kernel: SmMRq lift of ab = a || b
    ([k, 4, n] in q), tensor product in Bsk with the t-folded tables
    ``tb_bsk``, FastFloor against the t-scaled q-side product tx_q
    [k, 3, n].  Returns the floored [kb, 3, n]."""
    k, n = sc.conv.p_src.shape[0], tb_bsk.n
    _check_int32(ab, (k, 4, n), "bsk_branch_fused ab")
    _check_int32(tx_q, (k, 3, n), "bsk_branch_fused tx_q")
    _check_bsk_consts(sc, fc, tb_bsk, ab, tx_q, "bsk_branch_fused")
    if not on_card(ab, "bsk_branch_fused"):
        return _rns.bsk_branch_fused(ab, tx_q, sc, fc, tb_bsk)
    out = _bsk_branch_launch(ab[:, :, None], tx_q[:, :, None], sc, fc, tb_bsk,
                             "bsk_branch_fused")
    bsk_branch_fused.launches += 1
    return out[:, :, 0]


bsk_branch_fused.launches = 0


def bsk_branch_fused_batch(ab: torch.Tensor, tx_q: torch.Tensor,
                           sc: _rns.SmMRqConsts, fc: _rns.FastFloorConsts,
                           tb_bsk: NTTTables) -> torch.Tensor:
    """``bsk_branch_fused`` for B ciphertext pairs in one launch of B * kb
    clusters: ab [k, 4, B, n] and tx_q [k, 3, B, n], each with rows of n
    contiguous (views of per-ciphertext stacks are read in place).  Returns
    [kb, 3, B, n], slice b equal to
    ``bsk_branch_fused(ab[:, :, b], tx_q[:, :, b])``."""
    k, n, dev = sc.conv.p_src.shape[0], tb_bsk.n, tb_bsk.device
    check_views(ab, k, 4, n, dev, "bsk_branch_fused_batch ab")
    check_views(tx_q, k, 3, n, dev, "bsk_branch_fused_batch tx_q")
    if ab.shape[2] != tx_q.shape[2]:
        raise ValueError(f"bsk_branch_fused_batch: ab {list(ab.shape)}, tx_q "
                         f"{list(tx_q.shape)}: batch sizes differ")
    _check_bsk_consts(sc, fc, tb_bsk, ab, tx_q, "bsk_branch_fused_batch")
    if not on_card(ab, "bsk_branch_fused_batch"):
        return _rns.bsk_branch_fused_batch(ab, tx_q, sc, fc, tb_bsk)
    out = _bsk_branch_launch(ab, tx_q, sc, fc, tb_bsk, "bsk_branch_fused_batch")
    bsk_branch_fused_batch.launches += 1
    return out


bsk_branch_fused_batch.launches = 0


def fast_bconv_sk_fused(x_bsk: torch.Tensor, sk: _rns.SKConsts) -> torch.Tensor:
    """Exact Shenoy-Kumaresan conversion of x_bsk [l+1, B, n] (aux rows,
    then the m_sk row) to its [k, B, n] residues in q."""
    l, k = sk.conv_q.p_src.shape[0], sk.conv_q.p_dst.shape[0]
    if x_bsk.dim() != 3:
        raise ValueError(f"fast_bconv_sk_fused: expected [l+1, B, n], got "
                         f"{list(x_bsk.shape)}")
    _, batch, n = x_bsk.shape
    _check_int32(x_bsk, (l + 1, batch, n), "fast_bconv_sk_fused")
    if x_bsk.device != sk.B_mod_q.device:
        raise ValueError("fast_bconv_sk_fused: tensor and constants on "
                         "different devices")
    if not on_card(x_bsk, "fast_bconv_sk_fused"):
        return _rns.fast_bconv_sk(x_bsk, sk)
    out = torch.empty((k, batch, n), dtype=torch.int32, device=x_bsk.device)
    p = _build.ptr
    _build.launch(
        _lib().fhe_fast_bconv_sk, "fast_bconv_sk_fused", x_bsk.device,
        p(x_bsk), p(out), p(sk.conv_q.p_src), p(sk.conv_q.inv_phat),
        p(sk.conv_q.inv_phat_shoup), p(sk.conv_q.phat_mod_dst),
        p(sk.conv_q.phat_shoup_dst), p(sk.conv_sk.phat_mod_dst),
        p(sk.conv_sk.phat_shoup_dst), p(sk.conv_q.p_dst), p(sk.B_mod_q),
        p(sk.B_shoup_q), sk.m_sk, sk.inv_B_sk, sk.inv_B_sk_shoup, l, k,
        batch * n)
    fast_bconv_sk_fused.launches += 1
    return out


fast_bconv_sk_fused.launches = 0


def _check_conv_input(x: torch.Tensor, rows: int, consts: torch.Tensor,
                      name: str) -> None:
    """x an int32 contiguous [rows, B, n] tensor on the constants' device,
    small enough for the kernels' 32-bit offsets."""
    if x.dim() != 3:
        raise ValueError(f"{name}: expected [{rows}, B, n], got {list(x.shape)}")
    _check_int32(x, (rows, *x.shape[1:]), name)
    if x.device != consts.device:
        raise ValueError(f"{name}: tensor and constants on different devices")
    if x.numel() >= 1 << 31:
        raise ValueError(f"{name}: tensor too large for 32-bit offsets")


def sm_mrq_fused(x: torch.Tensor, sc: _rns.SmMRqConsts) -> torch.Tensor:
    """SmMRq centred lift of x [k, B, n] (residues in q) into the dst base
    (the Bsk base of the multiply): [l, B, n], each residue that of x or of
    x - q, whichever is centred.  The lift step of ``bsk_branch_fused`` on
    its own (the n < 1024 multiply)."""
    k, l = sc.conv.p_src.shape[0], sc.conv.p_dst.shape[0]
    _check_conv_input(x, k, sc.conv.p_src, "sm_mrq_fused")
    if not on_card(x, "sm_mrq_fused"):
        return _rns.sm_mrq(x, sc)
    _, batch, n = x.shape
    out = torch.empty((l, batch, n), dtype=torch.int32, device=x.device)
    p = _build.ptr
    _build.launch(
        _lib().fhe_sm_mrq, "sm_mrq_fused", x.device, p(x), p(out), p(sc.conv.p_src),
        p(sc.mt_times_inv_phat), p(sc.mt_times_inv_phat_shoup), p(sc.conv.phat_mod_dst),
        p(sc.conv.phat_shoup_dst), p(sc.phat_mod_mt), p(sc.conv.p_dst), p(sc.q_mod_dst),
        p(sc.q_shoup_dst), p(sc.inv_mt_dst), p(sc.inv_mt_shoup_dst), sc.inv_q_mt, k, l,
        batch * n)
    sm_mrq_fused.launches += 1
    return out


sm_mrq_fused.launches = 0


def fast_floor_fused(tx_q: torch.Tensor, tx_bsk: torch.Tensor,
                     fc: _rns.FastFloorConsts) -> torch.Tensor:
    """FastFloor: from the residues of t*x in q (tx_q [k, B, n]) and in the
    dst base (tx_bsk [l, B, n]), floor(t*x/q) - alpha (alpha < k) in the
    dst base, [l, B, n].  The floor step of ``bsk_branch_fused`` on its own
    (the n < 1024 multiply)."""
    k, l = fc.conv.p_src.shape[0], fc.conv.p_dst.shape[0]
    _check_conv_input(tx_q, k, fc.inv_q_dst, "fast_floor_fused tx_q")
    _check_conv_input(tx_bsk, l, fc.inv_q_dst, "fast_floor_fused tx_bsk")
    if tx_bsk.shape[1:] != tx_q.shape[1:]:
        raise ValueError(f"fast_floor_fused: tx_q {list(tx_q.shape)}, tx_bsk "
                         f"{list(tx_bsk.shape)}")
    if not on_card(tx_q, "fast_floor_fused"):
        return _rns.fast_floor(tx_q, tx_bsk, fc)
    _, batch, n = tx_q.shape
    out = torch.empty_like(tx_bsk)
    p = _build.ptr
    _build.launch(
        _lib().fhe_fast_floor, "fast_floor_fused", tx_q.device, p(tx_q), p(tx_bsk),
        p(out), p(fc.conv.p_src), p(fc.conv.inv_phat), p(fc.conv.inv_phat_shoup),
        p(fc.conv.phat_mod_dst), p(fc.conv.phat_shoup_dst), p(fc.conv.p_dst),
        p(fc.inv_q_dst), p(fc.inv_q_shoup_dst), k, l, batch * n)
    fast_floor_fused.launches += 1
    return out


fast_floor_fused.launches = 0
