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
in ``<wrapper>.launches``; a base conversion in the tiled instance (past
the deep instance's 108 q and 112 Bsk primes) takes two or four launches a
call, which ``fast_bconv_sk_fused.tiled_launches`` and
``fast_floor_fused.tiled_launches`` count.  The n < 1024 multiply's lift,
rns_pallas.py's ``sm_mrq_fused``, is the Lift lane of
``ntt_cuda.tensor_product``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from . import _build
from . import rns as _rns
from .ntt import NTTTables
from .ntt_cuda import (check_aligned_tables, check_barrett, check_views, column_block_product,
                       column_form, column_geometry, log2_exact, on_card,
                       product_form, scratch_for, table_ptrs, tensor_product_geometry)

_P = ctypes.c_void_p
_U = ctypes.c_uint32
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("rns")
    lib.fhe_bsk_branch.argtypes = ([_P] + [_I] * 3 + [_P] + [_I] * 3 + [_P] * 11
                                   + [_U] + [_P] * 14 + [_I] * 7 + [_P] * 2)
    lib.fhe_base_conv.argtypes = [_I] * 8 + [_P] * 24 + [_U] * 3 + [_P]
    lib.fhe_base_conv_tiled.argtypes = [_I] * 7 + [_P] * 25 + [_U] * 3 + [_P]
    lib.fhe_column_lift.argtypes = [_P] + [_I] * 3 + [_P] * 11 + [_U] + [_P] * 3 + [_I] * 7 + [_P]
    lib.fhe_column_floor.argtypes = [_P, _P] + [_I] * 3 + [_P] * 13 + [_I] * 7 + [_P]
    for f in (lib.fhe_bsk_branch, lib.fhe_base_conv, lib.fhe_base_conv_tiled,
              lib.fhe_column_lift, lib.fhe_column_floor):
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
    transform and floor; two padded rows of shared memory per CTA, at
    n = 32768 the ``half_row`` form, at n = 65536 the ``compact`` form with
    its ``scratch`` words, at n = 131072 the compact form on the quarter
    split, four CTAs a row, csrc/quarter.cuh).  At n >= 262144 (or inside
    ``forced_form("column")``) the column form: the lift's column launch into [kb, 4,
    B, n], tensor_product's block launch on the Bsk tables into [kb, 3, B,
    n] (7 kb B n words of scratch) and the floor's column launch.  Raise
    where nothing fits the card."""
    name = "bsk_branch_fused"
    if column_form(n):
        return column_geometry(n, kb, name, (("column", 4 * batch), ("product", batch),
                                             ("column", 3 * batch)), 7 * kb * batch * n)
    return tensor_product_geometry(n, kb, batch, name)


def column_bsk_branch(ab: torch.Tensor, tx_q: torch.Tensor, sc: _rns.SmMRqConsts,
                      fc: _rns.FastFloorConsts, tb_bsk: NTTTables, geo: dict,
                      name: str) -> torch.Tensor:
    """``_bsk_branch_launch`` in the column form ``geo``: the lift of ab
    [k, 4, B, n] into each Bsk prime with the forward's column stages
    (csrc/rns.cu column_lift_kernel), the block launch of tensor_product on
    the Bsk tables, and the inverse's column stages with the floor against
    tx_q (column_floor_kernel); returns [kb, 3, B, n]."""
    k, _, batch, n = ab.shape
    kb = tb_bsk.k
    logs = (geo["logn"], geo["logb"], geo["logc"])
    fwd = torch.empty((kb, 4, batch, n), dtype=torch.int32, device=ab.device)
    p = _build.ptr
    _build.launch(
        _lib().fhe_column_lift, name, ab.device, p(ab), *ab.stride()[:3], p(fwd),
        p(sc.conv.p_src), p(sc.mt_times_inv_phat), p(sc.mt_times_inv_phat_shoup),
        p(sc.conv.phat_mod_dst), p(sc.conv.phat_shoup_dst), p(sc.phat_mod_mt), p(sc.q_mod_dst),
        p(sc.q_shoup_dst), p(sc.inv_mt_dst), p(sc.inv_mt_shoup_dst), sc.inv_q_mt,
        p(tb_bsk.p), p(tb_bsk.psi_br), p(tb_bsk.psi_br_shoup), k, kb, batch, *logs,
        geo["steps"][0]["threads"])
    rows = column_block_product(fwd, tb_bsk, geo, name, 1)
    out = torch.empty_like(rows)
    _build.launch(
        _lib().fhe_column_floor, name, ab.device, p(rows), p(tx_q), *tx_q.stride()[:3], p(out),
        p(sc.conv.p_src), p(fc.conv.inv_phat), p(fc.conv.inv_phat_shoup),
        p(fc.conv.phat_mod_dst), p(fc.conv.phat_shoup_dst), p(fc.inv_q_dst),
        p(fc.inv_q_shoup_dst), p(tb_bsk.p), p(tb_bsk.ipsi_br), p(tb_bsk.ipsi_br_shoup),
        p(tb_bsk.n_inv), p(tb_bsk.n_inv_shoup), k, kb, batch, *logs,
        geo["steps"][2]["threads"])
    return out


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
    if geo.get("column"):
        return column_bsk_branch(ab, tx_q, sc, fc, tb_bsk, geo, name)
    out = torch.empty((kb, 3, batch, n), dtype=torch.int32, device=ab.device)
    scratch = scratch_for(geo, ab.device)
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
        geo["threads"], geo["smem"], product_form(geo), None if scratch is None else p(scratch))
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


# The least Bsk prime count the base-conversion kernel takes (csrc/rns.cu:
# kMinKb).  The fixed instances take up to CONV_FIXED_KB Bsk primes and
# floor from up to CONV_FIXED_FLOOR_K q primes (kMaxKb, kMaxFloorK), the
# wide instance up to CONV_WIDE_KB and CONV_WIDE_FLOOR_K (kWideKb,
# kWideFloorK) at one word per thread, the deep instance up to CONV_DEEP_KB
# Bsk and CONV_DEEP_K q primes (kDeepMaxKb, kDeepMaxK) at one word per thread
# and CONV_DEEP_THREADS per CTA (kDeepThreads), and the tiled instance the
# rest, with no cap; and its lanes
CONV_MIN_KB = 2
CONV_FIXED_KB = 17
CONV_FIXED_FLOOR_K = 16
CONV_WIDE_KB = 33
CONV_WIDE_FLOOR_K = 32
CONV_DEEP_KB = 112
CONV_DEEP_K = 108
CONV_DEEP_THREADS = 128
CONV_LANES = {"sk": 0, "floor": 1, "floor_sk": 2}
# SMs of an H100 SXM
CARD_SMS = 132
# The tiled instance (csrc/rns.cu kTileJ, kTileE, kTiledThreads, kFold,
# kTableStride): tiles of CONV_TILE_PRIMES destination primes x
# CONV_TILE_WORDS words, the source primes CONV_TILE_FOLD at a time through
# CONV_TILED_SMEM bytes of static shared memory (the digits [16, 128] and
# the table slice [16, 36]), whatever k and kb
CONV_TILE_PRIMES = 32
CONV_TILE_WORDS = 128
CONV_TILE_FOLD = 16
CONV_TILED_THREADS = 256
CONV_TILED_SMEM = 4 * CONV_TILE_FOLD * (CONV_TILE_WORDS + CONV_TILE_PRIMES + 4)


def conv_wide(lane: str, kb: int, k: int) -> bool:
    """True where a call of ``lane`` with kb Bsk primes and k q primes takes
    the wide instance: kb above CONV_FIXED_KB, or a floor from more than
    CONV_FIXED_FLOOR_K q primes."""
    return kb > CONV_FIXED_KB or (lane != "sk" and k > CONV_FIXED_FLOOR_K)


def conv_deep(lane: str, kb: int, k: int) -> bool:
    """True where such a call takes the deep instance: kb above
    CONV_WIDE_KB, or a floor from more than CONV_WIDE_FLOOR_K q primes."""
    return kb > CONV_WIDE_KB or (lane != "sk" and k > CONV_WIDE_FLOOR_K)


def conv_tiled(lane: str, kb: int, k: int) -> bool:
    """True where such a call takes the tiled instance: kb above
    CONV_DEEP_KB or k above CONV_DEEP_K (every lane stages a [k, kb] table
    in the deep instance), or inside ``forced_tiled()``."""
    if lane not in CONV_LANES:
        raise ValueError(f"unknown base-conversion lane {lane!r}")
    return _FORCED_TILED[0] or kb > CONV_DEEP_KB or k > CONV_DEEP_K


_FORCED_TILED = [False]


@contextlib.contextmanager
def forced_tiled():
    """Inside the block every base conversion takes the tiled instance
    (chip_smoke.py's comparison of the tiled and deep instances at kb = 63
    and 68); the choice before is restored on leaving it."""
    before, _FORCED_TILED[0] = _FORCED_TILED[0], True
    try:
        yield
    finally:
        _FORCED_TILED[0] = before


def conv_tiled_geometry(count: int, lane: str, kb: int, k: int) -> dict:
    """Launch shape of the tiled instance (csrc/rns.cu
    fhe_base_conv_tiled) over rows of ``count`` words: the scratch rows'
    ``pitch`` (count rounded up to whole tiles of words), the ``steps`` in
    order, each a ``digits`` launch (one word a thread, ``rows`` source
    rows) or a ``product`` launch (CONV_TILE_PRIMES x CONV_TILE_WORDS tiles
    of ``dst`` destination primes from ``src`` source digit rows; ``blocks``
    = its prime tiles x word tiles), and the ``scratch`` words: SK its l aux
    digit rows and alpha, Floor its k digit rows, FloorSK both and the
    floored [kb, pitch] between them.  ``smem`` and ``threads`` are the same
    at every k and kb."""
    if lane not in CONV_LANES:
        raise ValueError(f"unknown base-conversion lane {lane!r}")
    if kb < CONV_MIN_KB or k < 1 or count < 1:
        raise ValueError(f"conv_tiled_geometry: kb={kb}, k={k}, count={count}")
    tiles_e = -(-count // CONV_TILE_WORDS)
    pitch, l = tiles_e * CONV_TILE_WORDS, kb - 1
    digits = lambda rows: {"kernel": "digits", "rows": rows,
                           "blocks": -(-count // CONV_TILED_THREADS)}
    product = lambda src, dst: {"kernel": "product", "src": src, "dst": dst,
                                "blocks": -(-dst // CONV_TILE_PRIMES) * tiles_e}
    floor = [digits(k), product(k, kb)]
    sk = [digits(kb), product(l, k)]
    steps = sk if lane == "sk" else floor if lane == "floor" else floor + sk
    scratch_rows = ((k if lane != "sk" else 0) + (kb if lane == "floor_sk" else 0)
                    + (l + 1 if lane != "floor" else 0))
    return {"pitch": pitch, "threads": CONV_TILED_THREADS, "smem": CONV_TILED_SMEM,
            "steps": steps, "scratch": scratch_rows * pitch}


def conv_geometry(count: int, lane: str, wide: bool = False, deep: bool = False) -> dict:
    """Launch shape of the base-conversion kernel (``csrc/rns.cu``
    base_conv_kernel) over rows of ``count`` words: ``per_thread``
    consecutive words of every row per thread, ``threads`` per CTA and
    ``blocks``.  The SK lane takes 2 words per thread where the grid still
    fills the card twice over at 256 threads, and a CTA has 128 threads
    where 256 would leave SMs idle (scripts/conv_geometry_sweep.py, PERF.md:
    1 word at [5,3,8192] and [10,3,8192], 2 at [5,24,8192] and
    [10,24,8192], 128 threads at n = 256; 4 words were slower at all four
    B6 shapes).  The wide instance (``conv_wide``) takes one word per
    thread: its registers hold up to 33 rows of digits.  The deep instance
    (``conv_deep``) takes one word per thread and CONV_DEEP_THREADS per
    CTA: each thread's digits take a row of its shared memory."""
    if lane not in CONV_LANES:
        raise ValueError(f"unknown base-conversion lane {lane!r}")
    per_thread = 1
    if (lane == "sk" and not (wide or deep) and count % 2 == 0
            and count // (2 * 256) >= 2 * CARD_SMS):
        per_thread = 2
    groups = count // per_thread
    threads = CONV_DEEP_THREADS if deep else 256 if groups >= 256 * CARD_SMS else 128
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
    """One base-conversion call over src [r, R, n] (and txb [kb, R, n]):
    out [rows_out, R, n] and, with digits, d [k, R / 3, n]; and the tiled
    instance's kernel launches it took (0 for one base_conv_kernel launch)."""
    _, rows, n = src.shape
    count = rows * n
    if rows_out * count >= 1 << 31:
        raise ValueError(f"{name}: tensor too large for 32-bit offsets")
    kb = fc.conv.p_dst.shape[0] if fc is not None else sk.conv_q.p_src.shape[0] + 1
    if kb < CONV_MIN_KB:
        raise ValueError(f"{name}: the kernel takes at least {CONV_MIN_KB} Bsk primes, "
                         f"got {kb}")
    k = src.shape[0] if lane != "sk" else sk.conv_q.p_dst.shape[0]
    tiled = conv_tiled(lane, kb, k)
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
    result = out if d is None else (out, d)
    if tiled:
        geo = conv_tiled_geometry(count, lane, kb, k)
        scratch = torch.empty(geo["scratch"], dtype=torch.int32, device=src.device)
        dstart = 2 * count // 3
        vec = (count % 4 == 0 and dstart % 4 == 0
               and conv_vec(4, *(x for x in (txb, out, d) if x is not None)))
        _build.launch(
            _lib().fhe_base_conv_tiled, name, src.device, CONV_LANES[lane], kb, k, count,
            dstart, geo["pitch"], int(vec), p(src), p(txb), p(out), p(d), p(scratch),
            *sk_ptrs, *w_ptrs, *fc_ptrs, *scalars)
        return result, len(geo["steps"])
    geo = conv_geometry(count, lane, conv_wide(lane, kb, k), conv_deep(lane, kb, k))
    v = geo["per_thread"]
    vec = conv_vec(v, *(x for x in (src, txb) if x is not None))
    _build.launch(
        _lib().fhe_base_conv, name, src.device, CONV_LANES[lane], v, kb, k, count,
        2 * count // 3, int(vec), geo["threads"], p(src), p(txb), p(out), p(d),
        *sk_ptrs, *w_ptrs, *fc_ptrs, *scalars)
    return result, 0


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
    out, tiled = _conv_launch("sk", x_bsk, None, sk, None, digits, k, "fast_bconv_sk_fused")
    fast_bconv_sk_fused.launches += 1
    fast_bconv_sk_fused.tiled_launches += tiled
    return out


fast_bconv_sk_fused.launches = 0
fast_bconv_sk_fused.tiled_launches = 0


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
        out, tiled = _conv_launch("floor", tx_q, tx_bsk, None, fc, None, l, "fast_floor_fused")
    else:
        out, tiled = _conv_launch("floor_sk", tx_q, tx_bsk, sk, fc, digits, k,
                                  "fast_floor_fused")
    fast_floor_fused.launches += 1
    fast_floor_fused.tiled_launches += tiled
    return out


fast_floor_fused.launches = 0
fast_floor_fused.tiled_launches = 0
