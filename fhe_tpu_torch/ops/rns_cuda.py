"""BEHZ conversion kernel wrappers — counterpart of ``fhe_tpu/ops/rns_pallas.py``.

``bsk_branch_fused`` (and ``bsk_branch_fused_batch``, the same kernel with
a batch grid axis), ``fast_bconv_sk_fused`` (with the relinearization
digits as an option) and the n < 1024 multiply's ``fast_floor_fused`` (with
the conversion to q as an option) launch the hand-written CUDA kernels of
``csrc/rns.cu`` (design and bound: the note at the top of that file) for
CUDA tensors and use the plain PyTorch versions of ``ops/rns.py``
(``bsk_branch_fused``, ``bsk_branch_fused_batch``, ``fast_bconv_sk`` and
``fast_bconv_sk_digits``, ``fast_floor`` and ``fast_floor_sk``) for CPU
tensors; any other device raises.  Each wrapper counts its kernel launches
in ``<wrapper>.launches``.  The n < 1024 multiply's lift, rns_pallas.py's
``sm_mrq_fused``, is the Lift lane of ``ntt_cuda.tensor_product``.
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


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("rns")
    lib.fhe_bsk_branch.argtypes = ([_P] + [_I] * 3 + [_P] + [_I] * 3 + [_P] * 11
                                   + [_U] + [_P] * 14 + [_I] * 6 + [_P])
    lib.fhe_base_conv.argtypes = [_I] * 8 + [_P] * 24 + [_U] * 3 + [_P]
    for f in (lib.fhe_bsk_branch, lib.fhe_base_conv):
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


# Bsk prime counts the base-conversion kernel is instantiated for
# (csrc/rns.cu: kMinKb, kMaxKb), the most q primes its floor sums, and its
# lanes
CONV_KB = (2, 17)
CONV_MAX_FLOOR_K = 16
CONV_LANES = {"sk": 0, "floor": 1, "floor_sk": 2}
# SMs of an H100 SXM
CARD_SMS = 132


def conv_geometry(count: int, lane: str) -> dict:
    """Launch shape of the base-conversion kernel (``csrc/rns.cu``
    base_conv_kernel) over rows of ``count`` words: ``per_thread``
    consecutive words of every row per thread, ``threads`` per CTA and
    ``blocks``.  The SK lane takes 2 words per thread where the grid still
    fills the card twice over at 256 threads, and a CTA has 128 threads
    where 256 would leave SMs idle (scripts/conv_geometry_sweep.py, PERF.md:
    1 word at [5,3,8192] and [10,3,8192], 2 at [5,24,8192] and
    [10,24,8192], 128 threads at n = 256; 4 words were slower at all four
    B6 shapes)."""
    if lane not in CONV_LANES:
        raise ValueError(f"unknown base-conversion lane {lane!r}")
    per_thread = 1
    if lane == "sk" and count % 2 == 0 and count // (2 * 256) >= 2 * CARD_SMS:
        per_thread = 2
    groups = count // per_thread
    threads = 256 if groups >= 256 * CARD_SMS else 128
    return {"per_thread": per_thread, "threads": threads, "blocks": -(-groups // threads)}


def conv_vec(per_thread: int, *inputs: torch.Tensor) -> bool:
    """True where every input starts aligned to ``per_thread`` words: then
    the kernel reads a thread's words in one 8-byte access (every
    row of count words, count a multiple of per_thread, starts aligned too),
    else a word at a time."""
    return all(x.data_ptr() % (4 * per_thread) == 0 for x in inputs)


def _check_digits(digits, k: int, rows: int, dev, name: str) -> None:
    """digits = (inv_qhat, its Shoup companions), two [k] tensors on dev, for
    rows that are components 0, 1, 2 of rows / 3 elements."""
    if len(digits) != 2 or any(tuple(w.shape) != (k,) or w.device != dev for w in digits):
        raise ValueError(f"{name}: digits must be two [{k}] tensors on {dev} "
                         "(inv_qhat and its Shoup companions)")
    if rows % 3:
        raise ValueError(f"{name}: the digits lane needs rows of 3 components, got {rows} rows")


def _conv_launch(lane: str, src: torch.Tensor, txb, sk, fc, digits,
                 rows_out: int, name: str):
    """One base_conv_kernel launch over src [r, R, n] (and txb [kb, R, n]):
    out [rows_out, R, n] and, with digits, d [k, R / 3, n]."""
    _, rows, n = src.shape
    count = rows * n
    if rows_out * count >= 1 << 31:
        raise ValueError(f"{name}: tensor too large for 32-bit offsets")
    kb = fc.conv.p_dst.shape[0] if fc is not None else sk.conv_q.p_src.shape[0] + 1
    if not CONV_KB[0] <= kb <= CONV_KB[1]:
        raise ValueError(f"{name}: the kernel takes {CONV_KB[0]} to {CONV_KB[1]} Bsk "
                         f"primes, got {kb}")
    k = src.shape[0] if lane != "sk" else sk.conv_q.p_dst.shape[0]
    if lane != "sk" and k > CONV_MAX_FLOOR_K:
        raise ValueError(f"{name}: the kernel floors from at most {CONV_MAX_FLOOR_K} q "
                         f"primes, got {k}")
    geo = conv_geometry(count, lane)
    v = geo["per_thread"]
    vec = conv_vec(v, *(x for x in (src, txb) if x is not None))
    out = torch.empty((rows_out, rows, n), dtype=torch.int32, device=src.device)
    d = None
    if digits is not None:
        d = torch.empty((k, rows // 3, n), dtype=torch.int32, device=src.device)
    p = lambda x: None if x is None else _build.ptr(x)
    sk_ptrs = [None] * 10 if sk is None else [
        p(sk.conv_q.p_src), p(sk.conv_q.inv_phat), p(sk.conv_q.inv_phat_shoup),
        p(sk.conv_q.phat_mod_dst), p(sk.conv_sk.phat_mod_dst), p(sk.conv_q.p_dst),
        p(sk.conv_q.dst_wide), p(sk.conv_sk.dst_wide), p(sk.B_mod_q), p(sk.B_shoup_q)]
    fc_ptrs = [None] * 8 if fc is None else [
        p(fc.conv.p_src), p(fc.conv.inv_phat), p(fc.conv.inv_phat_shoup),
        p(fc.conv.phat_mod_dst), p(fc.conv.p_dst), p(fc.conv.dst_wide),
        p(fc.inv_q_dst), p(fc.inv_q_shoup_dst)]
    w_ptrs = [None, None] if digits is None else [p(digits[0]), p(digits[1])]
    scalars = (0, 0, 0) if sk is None else (sk.m_sk, sk.inv_B_sk, sk.inv_B_sk_shoup)
    _build.launch(
        _lib().fhe_base_conv, name, src.device, CONV_LANES[lane], v, kb, k, count,
        2 * count // 3, int(vec), geo["threads"], p(src), p(txb), p(out), p(d),
        *sk_ptrs, *w_ptrs, *fc_ptrs, *scalars)
    return out if d is None else (out, d)


def fast_bconv_sk_fused(x_bsk: torch.Tensor, sk: _rns.SKConsts, digits=None):
    """Exact Shenoy-Kumaresan conversion of x_bsk [l+1, R, n] (aux rows,
    then the m_sk row) to its [k, R, n] residues in q.  Given ``digits`` =
    (inv_qhat, its Shoup companions), two [k] tensors (the relinearization's
    (q/q_j)^-1 mod q_j), the R rows are components 0, 1 and 2 of R / 3
    elements, component-major, and the result is (out, d) with d [k, R/3, n]
    the gadget digits [c2_j * (q/q_j)^-1]_{q_j} of the c2 rows, which the
    kernel stores beside them."""
    l, k = sk.conv_q.p_src.shape[0], sk.conv_q.p_dst.shape[0]
    _check_conv_input(x_bsk, l + 1, sk.B_mod_q, "fast_bconv_sk_fused")
    if digits is not None:
        _check_digits(digits, k, x_bsk.shape[1], x_bsk.device, "fast_bconv_sk_fused")
    if not on_card(x_bsk, "fast_bconv_sk_fused"):
        if digits is None:
            return _rns.fast_bconv_sk(x_bsk, sk)
        return _rns.fast_bconv_sk_digits(x_bsk, sk, digits[0])
    out = _conv_launch("sk", x_bsk, None, sk, None, digits, k, "fast_bconv_sk_fused")
    fast_bconv_sk_fused.launches += 1
    return out


fast_bconv_sk_fused.launches = 0


def fast_floor_fused(tx_q: torch.Tensor, tx_bsk: torch.Tensor,
                     fc: _rns.FastFloorConsts, sk: _rns.SKConsts | None = None,
                     digits=None):
    """FastFloor: from the residues of t*x in q (tx_q [k, B, n]) and in the
    dst base (tx_bsk [l, B, n]), floor(t*x/q) - alpha (alpha < k) in the
    dst base, [l, B, n].  The floor step of ``bsk_branch_fused`` on its own.

    Given ``sk`` (the dst base is the Bsk base, aux primes then m_sk), the
    same launch converts the floored residues, kept in registers, exactly
    to q: ``fast_bconv_sk_fused(fast_floor_fused(tx_q, tx_bsk, fc), sk,
    digits)``, [k, B, n] (and the digits of its c2 rows), in one kernel:
    the n < 1024 multiply's floor and conversion."""
    k, l = fc.conv.p_src.shape[0], fc.conv.p_dst.shape[0]
    _check_conv_input(tx_q, k, fc.inv_q_dst, "fast_floor_fused tx_q")
    _check_conv_input(tx_bsk, l, fc.inv_q_dst, "fast_floor_fused tx_bsk")
    if tx_bsk.shape[1:] != tx_q.shape[1:]:
        raise ValueError(f"fast_floor_fused: tx_q {list(tx_q.shape)}, tx_bsk "
                         f"{list(tx_bsk.shape)}")
    if sk is not None:
        if sk.conv_q.p_src.shape[0] + 1 != l or sk.conv_q.p_dst.shape[0] != k:
            raise ValueError("fast_floor_fused: the SK constants do not convert the "
                             "floor's dst base back to its q primes")
        if sk.B_mod_q.device != tx_q.device:
            raise ValueError("fast_floor_fused: tensor and constants on different devices")
    if digits is not None:
        if sk is None:
            raise ValueError("fast_floor_fused: the digits lane needs sk")
        _check_digits(digits, k, tx_q.shape[1], tx_q.device, "fast_floor_fused")
    if not on_card(tx_q, "fast_floor_fused"):
        if sk is None:
            return _rns.fast_floor(tx_q, tx_bsk, fc)
        return _rns.fast_floor_sk(tx_q, tx_bsk, fc, sk,
                                  None if digits is None else digits[0])
    if sk is None:
        out = _conv_launch("floor", tx_q, tx_bsk, None, fc, None, l, "fast_floor_fused")
    else:
        out = _conv_launch("floor_sk", tx_q, tx_bsk, sk, fc, digits, k, "fast_floor_fused")
    fast_floor_fused.launches += 1
    return out


fast_floor_fused.launches = 0
