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
from .ntt_cuda import (MAX_GRID_Y, check_aligned_tables, check_barrett,
                       check_residues, check_smem, log2_exact, on_card,
                       regs_threads, table_ptrs)

_P = ctypes.c_void_p
_U = ctypes.c_uint32
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("decrypt")
    lib.fhe_decrypt_fused.argtypes = ([_P] * 2 + [_L] * 2 + [_P] * 15 + [_U] * 10
                                      + [_I] * 6 + [_P])
    lib.fhe_decrypt_fused.restype = ctypes.c_int
    return lib


# the largest portable cluster
MAX_CLUSTER = 8


def decrypt_geometry(n: int, k: int, batch: int = 1) -> dict:
    """Launch shape of ``decrypt_fused`` for B = ``batch`` ciphertext rows
    over k primes: one cluster of C = min(k, 8) CTAs per row, CTA r taking
    the primes r, r + C, ... (``primes_per_cta`` at most) and, after the
    cluster barrier, the epilogue of n / C coefficients; three padded rows
    of shared memory per CTA.  Raise where that does not fit the card."""
    name = "decrypt_fused"
    if k < 1 or not 1 <= batch <= MAX_GRID_Y:
        raise ValueError(f"{name}: k={k}, batch {batch} outside 1..{MAX_GRID_Y}")
    c = min(k, MAX_CLUSTER)
    return {"grid": (c, batch), "cluster": (c, 1, 1), "ctas": c * batch,
            "primes_per_cta": -(-k // c), "threads": regs_threads(n, name),
            "smem": check_smem(n, 3, name, padded=True)}


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
    out = torch.empty((batch, n), dtype=torch.int32, device=c0.device)
    p = _build.ptr
    _build.launch(
        _lib().fhe_decrypt_fused, "decrypt_fused", c0.device,
        p(c0), p(c1), c0.stride(0), c0.stride(1), p(s_ntt), p(out),
        *table_ptrs(tb), p(dc.gt_inv_phat), p(dc.gt_inv_phat_shoup),
        p(dc.phat_mod_t), p(dc.phat_shoup_t), p(dc.phat_mod_g),
        dc.t, dc.gamma, dc.gamma_mu, dc.neg_inv_q_t, dc.neg_inv_q_t_shoup,
        dc.neg_inv_q_g, dc.inv_gamma_t, dc.inv_gamma_t_shoup, dc.gamma_mod_t,
        dc.one_shoup_t, k, batch, log2_exact(n), geo["cluster"][0], geo["threads"],
        geo["smem"])
    decrypt_fused.launches += 1
    return out


decrypt_fused.launches = 0
