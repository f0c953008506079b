"""Fused decryption wrapper — counterpart of ``fhe_tpu/ops/decrypt_pallas.py``.

``decrypt_fused`` launches the hand-written CUDA kernel of ``csrc/decrypt.cu``
(design and bound: the note at the top of that file) for CUDA tensors and
uses ``decrypt_fused_plain`` for CPU tensors; any other device raises.
Launches are counted in ``decrypt_fused.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import modmath as mm
from . import ntt as _ntt
from . import rns as _rns
from .ntt import NTTTables
from .ntt_cuda import (COMPACT_SPLITS, MAX_CLUSTER, MAX_GRID_Y, check_aligned_tables,
                       check_barrett, check_residues, column_block_mul, column_form,
                       column_forward, column_geometry, compact_arg, fit_smem, log2_exact,
                       on_card, regs_threads, row_bytes, scratch_for, table_ptrs)

_P = ctypes.c_void_p
_U = ctypes.c_uint32
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("decrypt")
    lib.fhe_decrypt_fused.argtypes = ([_P] * 2 + [_L] * 2 + [_P] * 15 + [_U] * 10
                                      + [_I] * 6 + [_P, _I, _P])
    lib.fhe_decrypt_column.argtypes = ([_P, _P, _L, _L] + [_P] * 11 + [_U] * 10
                                       + [_I] * 6 + [_P])
    for f in (lib.fhe_decrypt_fused, lib.fhe_decrypt_column):
        f.restype = ctypes.c_int
    return lib


def decrypt_geometry(n: int, k: int, batch: int = 1) -> dict:
    """Launch shape of ``decrypt_fused`` for B = ``batch`` ciphertext rows
    over k primes: one cluster of C = min(k, 8) CTAs per row, CTA r taking
    the primes r, r + C, ... (``primes_per_cta`` at most) and, after the
    cluster barrier, the epilogue of coefficients [r n / C, (r + 1) n / C);
    three padded rows of shared memory per CTA (the working row and the
    CTA's two accumulators).  Where they do not fit a block (n = 32768),
    the ``wide`` form: the working row alone, the accumulators in a global
    scratch buffer of 2n words per CTA (``scratch`` words in all).  Where
    the working row does not fit either (n = 65536), the ``compact`` form:
    each prime's row split over H = 2 CTAs (``ctas_per_row``), a padded
    half row each, P = min(k, 8 / H) groups per cluster (C = H P,
    portable), group q taking the primes q, q + P, ...; each CTA's
    accumulators are 2n/H words of scratch (n/H each); at n = 131072, where
    a padded half row does not fit, the same with H = 4 (the quarter split:
    a padded quarter row per CTA, two groups per cluster).  At n >= 262144
    (or inside ``forced_form("column")``) the column form: c1's column launch, the block
    launch of mul_by_ntt_operand with s (2 k B n words of scratch between
    them), and a column launch that runs each prime's last inverse stages
    for a tile of columns, adds c0 and folds the prime's terms into the
    tile's accumulators, then scales them.  Raise where nothing fits the
    card."""
    name = "decrypt_fused"
    if k < 1 or not 1 <= batch <= MAX_GRID_Y:
        raise ValueError(f"{name}: k={k}, batch {batch} outside 1..{MAX_GRID_Y}")
    if column_form(n):
        return column_geometry(n, k, name, (("column", batch), ("mul", batch),
                                            ("decrypt", batch)), 2 * k * batch * n)
    row = row_bytes(n, padded=True)
    layout, smem = fit_smem(n, name, 3 * row, row,
                            *(row_bytes(n // h, padded=True) for h in COMPACT_SPLITS))
    compact = layout >= 2
    split = COMPACT_SPLITS[layout - 2] if compact else 1
    c = split * min(k, MAX_CLUSTER // split)
    threads = regs_threads(n, name, split)
    scratch = 2 * n * c * batch // split if layout >= 1 else 0
    return {"grid": (c, batch), "cluster": (c, 1, 1), "ctas": c * batch,
            "ctas_per_row": split, "primes_per_cta": -(-k // (c // split)),
            "threads": threads, "smem": smem, "wide": layout >= 1, "compact": compact,
            "scratch": scratch}


def decrypt_fused_plain(c0: torch.Tensor, c1: torch.Tensor, s_ntt: torch.Tensor,
                        tb: NTTTables, dc: _rns.DecryptConsts) -> torch.Tensor:
    """Plain version: phase = c0 + INTT(NTT(c1) ⊙ s), then the exact
    gamma-trick scaling of ``ops/rns.py``."""
    term = _ntt.ntt_inverse(_ntt.pointwise_mul(
        _ntt.ntt_forward(c1, tb), s_ntt.expand_as(c1), tb), tb)
    phase = mm.add_mod(c0, term, tb.p.view(-1, 1, 1))
    return _rns.decrypt_scale(phase, dc)


def decrypt_fused(c0: torch.Tensor, c1: torch.Tensor, s_ntt: torch.Tensor,
                  tb: NTTTables, dc: _rns.DecryptConsts) -> torch.Tensor:
    """m = round(t/q * [c0 + c1*s]_q) mod t for B ciphertexts at once.

    c0, c1: [k, B, n] coefficient-domain components, which may be views
    with the same strides and rows of n contiguous (``ct.data[:, 0:1]`` and
    ``ct.data[:, 1:2]``: the kernel reads them in place); s_ntt: [k, 1, n]
    NTT-form secret key.  Returns [B, n] int32 plaintext coefficients."""
    check_residues(c0, tb, "decrypt_fused c0", strided=True)
    check_residues(c1, tb, "decrypt_fused c1", strided=True)
    check_residues(s_ntt, tb, "decrypt_fused s_ntt")
    if (c1.shape != c0.shape or c1.stride() != c0.stride()
            or s_ntt.shape[1] != 1):
        raise ValueError(f"decrypt_fused: c0 {list(c0.shape)} strides "
                         f"{c0.stride()}, c1 {list(c1.shape)} strides "
                         f"{c1.stride()}, s {list(s_ntt.shape)}")
    if dc.p_src.shape[0] != tb.k or dc.p_src.device != tb.device:
        raise ValueError("decrypt_fused: constants do not match the tables")
    if not on_card(c0, "decrypt_fused"):
        return decrypt_fused_plain(c0, c1, s_ntt, tb, dc)
    check_barrett(tb, "decrypt_fused")
    check_aligned_tables(tb, "decrypt_fused")
    if s_ntt.data_ptr() % 16:
        raise ValueError("decrypt_fused: s_ntt is not 16-byte aligned")
    k, batch, n = c0.shape
    geo = decrypt_geometry(n, k, batch)
    if geo.get("column"):
        out = column_decrypt(c0, c1, s_ntt, tb, dc, geo)
        decrypt_fused.launches += 1
        return out
    out = torch.empty((batch, n), dtype=torch.int32, device=c0.device)
    scratch = scratch_for(geo, c0.device)
    p = _build.ptr
    _build.launch(
        _lib().fhe_decrypt_fused, "decrypt_fused", c0.device,
        p(c0), p(c1), c0.stride(0), c0.stride(1), p(s_ntt), p(out),
        *table_ptrs(tb), p(dc.gt_inv_phat), p(dc.gt_inv_phat_shoup),
        p(dc.phat_mod_t), p(dc.phat_shoup_t), p(dc.phat_mod_g),
        dc.t, dc.gamma, dc.gamma_mu, dc.neg_inv_q_t, dc.neg_inv_q_t_shoup,
        dc.neg_inv_q_g, dc.inv_gamma_t, dc.inv_gamma_t_shoup, dc.gamma_mod_t,
        dc.one_shoup_t, k, batch, log2_exact(n), geo["cluster"][0], geo["threads"],
        geo["smem"], None if scratch is None else p(scratch), compact_arg(geo))
    decrypt_fused.launches += 1
    return out


decrypt_fused.launches = 0


def column_decrypt(c0: torch.Tensor, c1: torch.Tensor, s_ntt: torch.Tensor, tb: NTTTables,
                   dc: _rns.DecryptConsts, geo: dict) -> torch.Tensor:
    """``decrypt_fused`` in the column form ``geo``: c1's column launch and
    the block launch of NTT(c1) . s (csrc/ntt.cu), then csrc/decrypt.cu's
    column launch (the last inverse stages of every prime, c0, the exact
    scaling); returns [B, n]."""
    name = "decrypt_fused"
    k, batch, n = c0.shape
    fwd = torch.empty((k, batch, n), dtype=torch.int32, device=c0.device)
    column_forward(c1, (c1.stride(0), 0, c1.stride(1)), 1, fwd, 0, tb, geo, name)
    rows = column_block_mul(fwd, s_ntt, tb, geo, name)
    out = torch.empty((batch, n), dtype=torch.int32, device=c0.device)
    p = _build.ptr
    _build.launch(
        _lib().fhe_decrypt_column, name, c0.device, p(rows), p(c0), c0.stride(0), c0.stride(1),
        p(out), p(tb.p), p(tb.ipsi_br), p(tb.ipsi_br_shoup), p(tb.n_inv), p(tb.n_inv_shoup),
        p(dc.gt_inv_phat), p(dc.gt_inv_phat_shoup), p(dc.phat_mod_t), p(dc.phat_shoup_t),
        p(dc.phat_mod_g), dc.t, dc.gamma, dc.gamma_mu, dc.neg_inv_q_t, dc.neg_inv_q_t_shoup,
        dc.neg_inv_q_g, dc.inv_gamma_t, dc.inv_gamma_t_shoup, dc.gamma_mod_t, dc.one_shoup_t,
        k, batch, geo["logn"], geo["logb"], geo["logc"], geo["steps"][2]["threads"])
    return out
