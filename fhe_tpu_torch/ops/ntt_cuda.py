"""NTT kernel wrappers — counterpart of ``fhe_tpu/ops/ntt_pallas.py``.

``ntt_forward``, ``ntt_inverse``, ``mul_by_ntt_operand`` (and ``_batch``),
``tensor_product`` (and ``_batch``; the single one with its Lift lane, the
n < 1024 multiply's products in q and in Bsk in one launch, with the lift
q -> Bsk, rns_pallas.py's ``sm_mrq_fused``, folded in), ``keyswitch_fused``
(and ``_batch``,
each with its ``prereduced`` and Galois lanes), ``ks_inner_batch`` and
``ks_inner_grouped`` (each with its Galois lane) launch the hand-written
CUDA kernels of ``csrc/ntt.cu`` (design and bound: the note at the top of
that file; their launch shapes, all thread-block clusters:
``ntt_forward_geometry``, ``ntt_inverse_geometry``,
``mul_by_ntt_operand_geometry``, ``tensor_product_geometry``,
``keyswitch_geometry`` and ``ks_inner_geometry``) for CUDA tensors and use
the plain PyTorch versions of ``ops/ntt.py`` for CPU tensors; any other
device raises.  A single function and its ``_batch`` form launch the same
kernel (the single one with a batch of 1), as do ``ks_inner_batch`` and
``ks_inner_grouped``, but each wrapper counts only
its own launches, in ``<wrapper>.launches`` (and its lanes in
``<wrapper>.prereduced_launches``, ``<wrapper>.galois_launches`` and
``tensor_product.lift_launches``).

The Galois lanes (galois_pallas.py's automorphisms, fused into the key
switch that consumes or produces their rows) take Galois elements g, not
the multipliers g^-1 mod 2n of ``ops/galois_cuda.py``.

Residues are int32 ``[k, batch, n]`` tensors; the kernels read the same bits
as uint32.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import ntt as _ntt
from . import rns as _rns
from .ntt import NTTTables

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# the kernels keep their polynomials in shared memory; a block may use at
# most 227 KB of it on Hopper
MAX_SMEM = 232448
# the largest grid x and y extents; the cluster kernels give the batch to y,
# ntt_forward and ntt_inverse to x
MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_Y = 65535


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("ntt")
    lib.fhe_ntt_forward.argtypes = [_P] * 5 + [_I] * 5 + [_P]
    lib.fhe_ntt_inverse.argtypes = [_P] * 7 + [_I] * 6 + [_P]
    lib.fhe_mul_by_ntt_operand.argtypes = ([_P] + [_L] * 2 + [_P] * 10
                                           + [_I] * 6 + [_P])
    lib.fhe_tensor_product.argtypes = ([_P] * 2 + [_L] * 3 + [_P] * 9 + [_I] * 5 + [_P] * 10
                                       + [ctypes.c_uint, _I] + [_P] * 9)
    lib.fhe_keyswitch.argtypes = ([_P] + [_L] * 3 + [_P] + [_L] * 2 + [_P] * 9
                                  + [_I] * 8 + [ctypes.c_uint, _P] + [_L] * 2 + [_I, _P])
    lib.fhe_ks_inner.argtypes = ([_P] + [_L] * 3 + [_I] + [_P] + [_L] * 3 + [_I]
                                 + [_P] * 7 + [_I] * 8 + [_P] * 3 + [_L] * 2 + [_P])
    for f in (lib.fhe_ntt_forward, lib.fhe_ntt_inverse,
              lib.fhe_mul_by_ntt_operand, lib.fhe_tensor_product,
              lib.fhe_keyswitch, lib.fhe_ks_inner):
        f.restype = ctypes.c_int
    return lib


def log2_exact(n: int) -> int:
    if n < 2 or n & (n - 1):
        raise ValueError(f"n must be a power of two >= 2, got {n}")
    return n.bit_length() - 1


def check_residues(x: torch.Tensor, tb: NTTTables, name: str,
                   strided: bool = False) -> None:
    """Raise unless x is a contiguous int32 [k, *, n] tensor matching tb.
    ``strided=True`` also takes a view whose rows of n are contiguous, for
    a kernel that reads its input through strides."""
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 residues, got {x.dtype}")
    if x.dim() != 3 or x.shape[0] != tb.k or x.shape[2] != tb.n:
        raise ValueError(f"{name}: expected shape [{tb.k}, *, {tb.n}], "
                         f"got {list(x.shape)}")
    if not (x.stride(2) == 1 if strided else x.is_contiguous()):
        raise ValueError(f"{name}: tensor must be contiguous"
                         + (" along n" if strided else ""))
    if x.device != tb.device:
        raise ValueError(f"{name}: tensor on {x.device}, tables on {tb.device}")


def on_card(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (plain version); raise for any other device."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {x.device}")


# the register-blocked sweep of csrc/modmath.cuh (kRegLog): 2^REG_LOG
# coefficients per thread and pass, rows padded by one word in 32
REG_LOG = 4


def row_bytes(n: int, padded: bool = False) -> int:
    """Shared-memory bytes of one row of n residues; ``padded`` for the
    register-blocked sweep's rows (element j at j + j // 32)."""
    return 4 * (n + n // 32 if padded else n)


def check_smem(n: int, polys: int, name: str, padded: bool = False) -> int:
    """Raise unless ``polys`` rows of n residues (padded ones with
    ``padded``) fit one block's shared memory; return their bytes."""
    nbytes = polys * row_bytes(n, padded)
    if nbytes > MAX_SMEM:
        raise ValueError(f"{name}: n={n} needs {nbytes} bytes of shared "
                         f"memory per block, more than {MAX_SMEM}")
    return nbytes


def check_aligned_tables(tb: NTTTables, name: str) -> None:
    """Raise unless every twiddle table starts 16-byte aligned, as the
    register-blocked sweep's vector loads of twiddle runs need (fresh
    tables and their row views are)."""
    for f in ("psi_br", "psi_br_shoup", "ipsi_br", "ipsi_br_shoup"):
        if getattr(tb, f).data_ptr() % 16:
            raise ValueError(f"{name}: table {f} is not 16-byte aligned")


def regs_threads(n: int, name: str, split: int = 1) -> int:
    """Threads per CTA of a kernel that runs the register-blocked sweep on
    one row of n, or on its 1/split share where ``split`` CTAs share the
    row: one group of 2^REG_LOG coefficients per thread and full pass, at
    least a warp and at most 512.  Raise for n below 2^(REG_LOG+1), which
    the sweep does not take."""
    logn = log2_exact(n)
    if logn <= REG_LOG:
        raise ValueError(f"{name}: n={n} is below {2 << REG_LOG}, the smallest "
                         "ring the register-blocked sweep takes")
    return min(max((n >> REG_LOG) // split, 32), 512)


# the cluster kernels of csrc/ntt.cu and csrc/rns.cu: the CTAs of a cluster
# that share a row's transforms, the tensor product's cluster, one pair of
# CTAs per input row x0, x1, y0, y1, and the most digit pairs of a
# keyswitch_fused cluster (kRowSplit, kProductCluster, kKeyswitchPairs)
ROW_SPLIT = 2
PRODUCT_CLUSTER = 4 * ROW_SPLIT
KEYSWITCH_PAIRS = 4
# tensor_product's Lift lane: the most source primes it lifts from
# (csrc/lift.cuh: kMaxLiftK) and the most threads a CTA gives the lift
LIFT_MAX_K = 16
LIFT_THREADS = 256


def ntt_forward_geometry(n: int, k: int, batch: int = 1,
                         name: str = "ntt_forward") -> dict:
    """Launch shape of ``ntt_forward`` for [k, batch, n]: one cluster of 2
    CTAs per (row, prime), which share the row's transform, the batch on
    grid x; one padded row of shared memory per CTA.  Raise where that does
    not fit the card."""
    if not 1 <= ROW_SPLIT * batch <= MAX_GRID_X:
        raise ValueError(f"{name}: batch {batch} outside 1..{MAX_GRID_X // ROW_SPLIT}")
    return {"grid": (ROW_SPLIT * batch, k), "cluster": (ROW_SPLIT, 1, 1),
            "ctas": ROW_SPLIT * batch * k, "ctas_per_row": ROW_SPLIT,
            "threads": regs_threads(n, name, ROW_SPLIT),
            "smem": check_smem(n, 1, name, padded=True)}


def ntt_inverse_geometry(n: int, k: int, batch: int = 1) -> dict:
    """Launch shape of ``ntt_inverse`` for [k, batch, n]: ntt_forward's, the
    mirror transform (a cluster of 2 CTAs per (row, prime), one padded row
    each).  Raise where that does not fit the card."""
    return ntt_forward_geometry(n, k, batch, "ntt_inverse")


def staged_smem(n: int, words: int, name: str) -> int:
    """Shared-memory bytes of ``words`` words of rows and a staged row of n
    words behind them, at a 16-byte boundary (csrc/ntt.cu: stage_offset), as
    the Galois lanes of keyswitch_fused and ks_inner use; raise where that
    does not fit a block."""
    total = -(-words // 4) * 4 + n
    if 4 * total > MAX_SMEM:
        raise ValueError(f"{name}: n={n} needs {4 * total} bytes of shared memory "
                         f"per block, more than {MAX_SMEM}")
    return 4 * total


def _padded(n: int) -> int:
    return row_bytes(n, padded=True) // 4


def ks_inner_geometry(n: int, k: int, batch: int = 1,
                      name: str = "ks_inner_batch", c0: bool = False) -> dict:
    """Launch shape of ``ks_inner_batch`` and ``ks_inner_grouped`` for B =
    ``batch`` elements over k primes: one cluster of 2 CTAs per (element,
    output row, prime), which share that row's inner product and inverse
    transform, grid (2, 2B, k); one padded row of shared memory per CTA,
    and with ``c0`` (the Galois lane adds phi_g(c0)) the c0 row staged
    behind it where both fit a block (n <= 16384; ``stage_c0``), else c0 is
    read in place.  Raise where that does not fit the card."""
    if not 1 <= 2 * batch <= MAX_GRID_Y:
        raise ValueError(f"{name}: batch {batch} outside 1..{MAX_GRID_Y // 2}")
    smem = check_smem(n, 1, name, padded=True)
    stage = c0 and 4 * (-(-_padded(n) // 4) * 4 + n) <= MAX_SMEM
    if stage:
        smem = staged_smem(n, _padded(n), name)
    return {"grid": (ROW_SPLIT, 2 * batch, k), "cluster": (ROW_SPLIT, 1, 1),
            "ctas": ROW_SPLIT * 2 * batch * k, "ctas_per_row": ROW_SPLIT,
            "threads": regs_threads(n, name, ROW_SPLIT), "smem": smem, "stage_c0": stage}


def keyswitch_geometry(n: int, k: int, kd: int, batch: int = 1,
                       name: str = "keyswitch_fused", galois: bool = False) -> dict:
    """Launch shape of ``keyswitch_fused`` (and ``_batch``, every lane) for
    kd digits of B = ``batch`` elements over k primes: one cluster of 2R
    CTAs per (element, prime), R = clamp(kd, 2, 4) digit pairs (two pairs at
    least, one per output row; at most 8 CTAs, the portable cluster size);
    pair r transforms digits r, r + R, ...; two padded rows of shared memory
    per CTA, and with ``galois`` (the Galois lane) the staged row it gathers
    from.  Raise where that does not fit the card."""
    if kd < 1:
        raise ValueError(f"{name}: kd={kd}, expected at least one digit")
    if not 1 <= batch <= MAX_GRID_Y:
        raise ValueError(f"{name}: batch {batch} outside 1..{MAX_GRID_Y}")
    pairs = min(max(kd, 2), KEYSWITCH_PAIRS)
    smem = (staged_smem(n, 2 * _padded(n), name) if galois
            else check_smem(n, 2, name, padded=True))
    return {"grid": (ROW_SPLIT * pairs, batch, k), "cluster": (ROW_SPLIT * pairs, 1, 1),
            "ctas": ROW_SPLIT * pairs * batch * k, "pairs": pairs, "ctas_per_row": ROW_SPLIT,
            "threads": regs_threads(n, name, ROW_SPLIT), "smem": smem}


def mul_by_ntt_operand_geometry(n: int, k: int, c: int, batch: int = 1) -> dict:
    """Launch shape of ``mul_by_ntt_operand`` (and ``_batch``) for B =
    ``batch`` rows of u against c operand rows over k primes: one cluster
    of 2 CTAs per (element, operand row, prime), which share the row's
    forward transform, product and inverse transform; one padded row of
    shared memory per CTA.  Raise where that does not fit the card."""
    name = "mul_by_ntt_operand"
    if not 1 <= c * batch <= MAX_GRID_Y:
        raise ValueError(f"{name}: {c} operand rows x batch {batch} outside "
                         f"1..{MAX_GRID_Y}")
    return {"grid": (ROW_SPLIT, c * batch, k), "cluster": (ROW_SPLIT, 1, 1),
            "ctas": ROW_SPLIT * c * batch * k, "ctas_per_row": ROW_SPLIT,
            "threads": regs_threads(n, name, ROW_SPLIT),
            "smem": check_smem(n, 1, name, padded=True)}


def tensor_product_geometry(n: int, k: int, batch: int = 1,
                            name: str = "tensor_product", lift: bool = False) -> dict:
    """Launch shape of the cluster tensor product (``tensor_product`` and
    ``_batch``; ``bsk_branch_fused`` passes its name) for B = ``batch``
    elements over k primes: one cluster of 8 CTAs per (element, prime), two
    per input row, which share the row's forward transform and, for rows 0
    to 2, its product row's inverse transform; two padded rows of shared
    memory per CTA.  The Lift lane (``lift``) has a thread per coefficient
    of the CTA's half row, up to LIFT_THREADS, for the lift before the
    first pass.  Raise where that does not fit the card."""
    if not 1 <= batch <= MAX_GRID_Y:
        raise ValueError(f"{name}: batch {batch} outside 1..{MAX_GRID_Y}")
    threads = regs_threads(n, name, ROW_SPLIT)
    if lift:
        threads = max(threads, min(n // ROW_SPLIT, LIFT_THREADS))
    return {"grid": (PRODUCT_CLUSTER, batch, k), "cluster": (PRODUCT_CLUSTER, 1, 1),
            "ctas": PRODUCT_CLUSTER * batch * k, "ctas_per_prime": PRODUCT_CLUSTER,
            "ctas_per_row": ROW_SPLIT, "threads": threads,
            "smem": check_smem(n, 2, name, padded=True)}


def check_barrett(tb: NTTTables, name: str) -> None:
    """Raise unless every prime of tb is a 30-bit prime (mu != 0), as the
    kernels' Barrett products need."""
    if not all((1 << 29) < q < (1 << 30) for q in tb.primes):
        raise ValueError(f"{name}: needs 30-bit primes (Barrett)")


def table_ptrs(tb: NTTTables) -> list:
    """Pointers to the primes, Barrett constants, twiddles and inverse
    normalisation, in the order the forward-and-inverse kernels of csrc/
    take them.  The kernels index row i of a [k, n] table at i * n from its
    pointer, which a row view of contiguous tables (``ntt.slice_tables``,
    ``slice_tables_last``: a level's primes) keeps, offset included."""
    return [_build.ptr(getattr(tb, f)) for f in (
        "p", "mu", "psi_br", "psi_br_shoup", "ipsi_br", "ipsi_br_shoup",
        "n_inv", "n_inv_shoup")]


def ntt_forward(a: torch.Tensor, tb: NTTTables) -> torch.Tensor:
    """[k, batch, n] forward NTT, natural -> bit-reversed order.  Any prime
    below 2^31 (Shoup twiddles: the q primes and the plaintext modulus t);
    on the card 32 <= n <= 32768 (``ntt_forward_geometry``)."""
    check_residues(a, tb, "ntt_forward")
    if not on_card(a, "ntt_forward"):
        return _ntt.ntt_forward(a, tb)
    k, batch, n = a.shape
    geo = ntt_forward_geometry(n, k, batch)
    check_aligned_tables(tb, "ntt_forward")
    out = torch.empty_like(a)
    p = _build.ptr
    _build.launch(_lib().fhe_ntt_forward, "ntt_forward", a.device,
                  p(a), p(out), p(tb.p), p(tb.psi_br), p(tb.psi_br_shoup),
                  k, batch, log2_exact(n), geo["threads"], geo["smem"])
    ntt_forward.launches += 1
    return out


ntt_forward.launches = 0


def aligned(x: torch.Tensor, *strides: int) -> bool:
    """True where x starts 16-byte aligned and each of ``strides`` (in
    elements) is a whole number of 16-byte words: then every row the
    strides reach starts aligned, and a kernel may read it in 16-byte
    words."""
    return x.data_ptr() % 16 == 0 and all(s % 4 == 0 for s in strides)


def ntt_inverse(a: torch.Tensor, tb: NTTTables) -> torch.Tensor:
    """[k, batch, n] inverse NTT, bit-reversed -> natural order, times n^-1.
    Any prime below 2^31, as ``ntt_forward``; on the card 32 <= n <= 32768
    (``ntt_inverse_geometry``).  An input that does not start 16-byte
    aligned is read a word at a time."""
    check_residues(a, tb, "ntt_inverse")
    if not on_card(a, "ntt_inverse"):
        return _ntt.ntt_inverse(a, tb)
    k, batch, n = a.shape
    geo = ntt_inverse_geometry(n, k, batch)
    check_aligned_tables(tb, "ntt_inverse")
    out = torch.empty_like(a)
    p = _build.ptr
    _build.launch(_lib().fhe_ntt_inverse, "ntt_inverse", a.device,
                  p(a), p(out), p(tb.p), p(tb.ipsi_br), p(tb.ipsi_br_shoup),
                  p(tb.n_inv), p(tb.n_inv_shoup), k, batch, log2_exact(n),
                  geo["threads"], geo["smem"], int(aligned(a)))
    ntt_inverse.launches += 1
    return out


ntt_inverse.launches = 0


def check_views(x: torch.Tensor, k: int, comps: int, n: int, device,
                name: str) -> None:
    """Raise unless x is an int32 [k, comps, B, n] tensor on ``device`` whose
    rows of n are contiguous (a view of a [B, k, comps, n] stack will do)."""
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 residues, got {x.dtype}")
    if x.dim() != 4 or (x.shape[0], x.shape[1], x.shape[3]) != (k, comps, n):
        raise ValueError(f"{name}: expected shape [{k}, {comps}, B, {n}], got "
                         f"{list(x.shape)}")
    if x.stride(3) != 1:
        raise ValueError(f"{name}: rows of n must be contiguous")
    if x.device != device:
        raise ValueError(f"{name}: tensor on {x.device}, expected {device}")


def _mul_by_ntt_operand_launch(u: torch.Tensor, w_ntt: torch.Tensor,
                               tb: NTTTables, name: str) -> torch.Tensor:
    """One launch over the B rows of u [k, B, n] (strided): [k, c, B, n]."""
    check_barrett(tb, name)
    check_aligned_tables(tb, name)
    if w_ntt.data_ptr() % 16:
        raise ValueError(f"{name}: w_ntt is not 16-byte aligned")
    k, batch, n = u.shape
    c = w_ntt.shape[1]
    geo = mul_by_ntt_operand_geometry(n, k, c, batch)
    out = torch.empty((k, c, batch, n), dtype=torch.int32, device=u.device)
    p = _build.ptr
    _build.launch(_lib().fhe_mul_by_ntt_operand, name, u.device, p(u),
                  u.stride(0), u.stride(1), p(w_ntt), p(out), *table_ptrs(tb),
                  k, c, batch, log2_exact(n), geo["threads"], geo["smem"])
    return out


def mul_by_ntt_operand(u: torch.Tensor, w_ntt: torch.Tensor,
                       tb: NTTTables) -> torch.Tensor:
    """INTT(NTT(u) ⊙ w_c): u a [k, 1, n] coefficient-domain polynomial, w_ntt
    a [k, c, n] NTT-form operand (the public key in encrypt); returns
    [k, c, n].  u may be a view whose rows of n are contiguous (one
    component of a ciphertext: the kernel reads it in place).  The pointwise
    product is a Barrett multiply, so every prime of tb must be a 30-bit
    prime (mu != 0); on the card n must be at least 32 (the
    register-blocked sweep) and w_ntt 16-byte aligned."""
    check_residues(u, tb, "mul_by_ntt_operand", strided=True)
    check_residues(w_ntt, tb, "mul_by_ntt_operand")
    if u.shape[1] != 1:
        raise ValueError(f"mul_by_ntt_operand: u must be [k, 1, n], got "
                         f"{list(u.shape)}")
    if not on_card(u, "mul_by_ntt_operand"):
        return _ntt.mul_by_ntt_operand(u, w_ntt, tb)
    out = _mul_by_ntt_operand_launch(u, w_ntt, tb, "mul_by_ntt_operand")
    mul_by_ntt_operand.launches += 1
    return out[:, :, 0]


mul_by_ntt_operand.launches = 0


def mul_by_ntt_operand_batch(u: torch.Tensor, w_ntt: torch.Tensor,
                             tb: NTTTables) -> torch.Tensor:
    """INTT(NTT(u_b) ⊙ w_c) for B polynomials u [k, B, n] (coefficient
    domain; rows of n contiguous, any other strides) against one shared
    [k, c, n] NTT-form operand, in one launch of c * B * k clusters;
    returns [k, c, B, n].  Slice b equals ``mul_by_ntt_operand(u[:, b:b+1], w)``."""
    check_residues(u, tb, "mul_by_ntt_operand_batch", strided=True)
    check_residues(w_ntt, tb, "mul_by_ntt_operand_batch")
    if not on_card(u, "mul_by_ntt_operand_batch"):
        return _ntt.mul_by_ntt_operand_batch(u, w_ntt, tb)
    out = _mul_by_ntt_operand_launch(u, w_ntt, tb, "mul_by_ntt_operand_batch")
    mul_by_ntt_operand_batch.launches += 1
    return out


mul_by_ntt_operand_batch.launches = 0


def _lift_args(lift, tq: NTTTables) -> list:
    """The Lift lane's operands in the order fhe_tensor_product takes them
    after the launch shape: the lift's constants (csrc/lift.cuh
    SmMRqOperands) and the q tables tq, or nulls for the plain lane."""
    if lift is None:
        return [None] * 10 + [0, 0] + [None] * 8
    sc = lift[0]
    p = _build.ptr
    return [p(sc.conv.p_src), p(sc.mt_times_inv_phat), p(sc.mt_times_inv_phat_shoup),
            p(sc.conv.phat_mod_dst), p(sc.conv.phat_shoup_dst), p(sc.phat_mod_mt),
            p(sc.q_mod_dst), p(sc.q_shoup_dst), p(sc.inv_mt_dst), p(sc.inv_mt_shoup_dst),
            sc.inv_q_mt, tq.k, *table_ptrs(tq)]


def _tensor_product_launch(x: torch.Tensor, y: torch.Tensor, tb: NTTTables,
                           name: str, lift=None) -> torch.Tensor:
    """One launch over x, y [k, 2, B, n] (the k primes of tb) with equal
    strides: [k, 3, B, n]; with ``lift`` = (sc, tb_bsk), [k + kb, 3, B, n],
    the product in q, then that of the lifts in Bsk.  The kernel's own
    tables are those of its last primes (tb_bsk in the Lift lane)."""
    tabs = [tb] if lift is None else [tb, lift[1]]
    for t in tabs:
        check_barrett(t, name)
        check_aligned_tables(t, name)
    _, _, batch, n = x.shape
    k = sum(t.k for t in tabs)
    geo = tensor_product_geometry(n, k, batch, name, lift=lift is not None)
    out = torch.empty((k, 3, batch, n), dtype=torch.int32, device=x.device)
    p = _build.ptr
    _build.launch(_lib().fhe_tensor_product, name, x.device, p(x), p(y),
                  x.stride(0), x.stride(1), x.stride(2), p(out), *table_ptrs(tabs[-1]),
                  k, batch, log2_exact(n), geo["threads"], geo["smem"], *_lift_args(lift, tb))
    return out


def _check_lift(sc: "_rns.SmMRqConsts", tb: NTTTables, tb_bsk: NTTTables) -> None:
    """sc lifts from the k primes of tb into the kb of tb_bsk, on their
    device, and k is at most LIFT_MAX_K."""
    k, kb = sc.conv.p_src.shape[0], sc.conv.p_dst.shape[0]
    if k > LIFT_MAX_K:
        raise ValueError(f"tensor_product: the Lift lane lifts from at most {LIFT_MAX_K} "
                         f"primes, got {k}")
    if (k, kb, tb.n) != (tb.k, tb_bsk.k, tb_bsk.n):
        raise ValueError(f"tensor_product: lift constants from {k} into {kb} primes, "
                         f"tables of {tb.k} and {tb_bsk.k} primes at n = {tb.n}, {tb_bsk.n}")
    if not sc.q_mod_dst.device == tb_bsk.device == tb.device:
        raise ValueError("tensor_product: lift constants and tables on different devices")


def tensor_product(x: torch.Tensor, y: torch.Tensor, tb: NTTTables, lift=None):
    """(x0*y0, x0*y1 + x1*y0, x1*y1) of two [k, 2, n] coefficient-domain
    ciphertext halves; returns [k, 3, n].  With the multiply's tables
    (``ntt.build_mul_tables``) the result is t times the product.  Every
    prime must be a 30-bit prime (Barrett); on the card 32 <= n <= 16384
    (``tensor_product_geometry``: two padded rows per CTA).  x and y may be
    views with rows of n contiguous and equal strides (the halves of a
    lifted [k, 4, n] tensor: the kernel reads them in place).

    The Lift lane, the n < 1024 multiply's two products in one launch:
    given ``lift`` = (sc, tb_bsk), the SmMRq constants from tb's k primes
    into the kb primes of tb_bsk and tb_bsk, it returns (tx_q, tx_bsk):
    ``tensor_product(x, y, tb)`` [k, 3, n] and the [kb, 3, n] product of
    the centred lifts of x and y, ``rns.tensor_product_lift(x, y, sc,
    tb_bsk)`` (the lift, rns_pallas.py's ``sm_mrq_fused``, then the product
    in Bsk), both views of one [k + kb, 3, n] tensor.  Launches count in
    ``launches`` and ``lift_launches`` by lane."""
    check_residues(x, tb, "tensor_product", strided=True)
    check_residues(y, tb, "tensor_product", strided=True)
    if x.shape[1] != 2 or y.shape != x.shape or y.stride() != x.stride():
        raise ValueError(f"tensor_product: x {list(x.shape)} strides {x.stride()}, "
                         f"y {list(y.shape)} strides {y.stride()}; expected two "
                         "[k, 2, n] with equal strides")
    if lift is not None:
        _check_lift(lift[0], tb, lift[1])
    if not on_card(x, "tensor_product"):
        if lift is None:
            return _ntt.tensor_product(x, y, tb)
        return _ntt.tensor_product(x, y, tb), _rns.tensor_product_lift(x, y, *lift)
    out = _tensor_product_launch(x[:, :, None], y[:, :, None], tb, "tensor_product",
                                 lift)[:, :, 0]
    if lift is None:
        tensor_product.launches += 1
        return out
    tensor_product.lift_launches += 1
    return out[:tb.k], out[tb.k:]


tensor_product.launches = 0
tensor_product.lift_launches = 0


def tensor_product_batch(x: torch.Tensor, y: torch.Tensor,
                         tb: NTTTables) -> torch.Tensor:
    """``tensor_product`` of B pairs at once: x, y [k, 2, B, n] with rows of
    n contiguous and the same strides (views of one [B, k, 4, n] stack are
    read in place); one launch of B * k clusters; returns [k, 3, B, n]."""
    check_views(x, tb.k, 2, tb.n, tb.device, "tensor_product_batch")
    check_views(y, tb.k, 2, tb.n, tb.device, "tensor_product_batch")
    if y.shape != x.shape or y.stride() != x.stride():
        raise ValueError(f"tensor_product_batch: x {list(x.shape)} strides "
                         f"{x.stride()}, y {list(y.shape)} strides {y.stride()}")
    if not on_card(x, "tensor_product_batch"):
        return _ntt.tensor_product_batch(x, y, tb)
    out = _tensor_product_launch(x, y, tb, "tensor_product_batch")
    tensor_product_batch.launches += 1
    return out


tensor_product_batch.launches = 0


def _check_keys(keys_t: torch.Tensor, kd: int, tb: NTTTables, name: str) -> None:
    k, n = tb.k, tb.n
    if keys_t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 residues")
    if keys_t.shape != (k, kd, 2, n):
        raise ValueError(f"{name}: keys {list(keys_t.shape)}, expected "
                         f"[{k}, {kd}, 2, {n}]")
    if keys_t.stride()[2:] != (n, 1):
        raise ValueError(f"{name}: each key's [2, n] block must be contiguous")
    if keys_t.device != tb.device:
        raise ValueError(f"{name}: keys and tables on different devices")


def _check_digits(d: torch.Tensor, tb: NTTTables, prereduced: bool,
                  name: str) -> None:
    """Raise unless d is an int32 [kd, B, n] stack, or [k, kd, B, n] when
    prereduced, on tb's device with rows of n contiguous."""
    if d.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 residues")
    want = "[k, kd, B, n]" if prereduced else "[kd, B, n]"
    if (d.dim() != (4 if prereduced else 3) or d.shape[-1] != tb.n
            or d.stride(-1) != 1 or (prereduced and d.shape[0] != tb.k)):
        raise ValueError(f"{name}: d {list(d.shape)}, expected {want} with k = "
                         f"{tb.k}, n = {tb.n} and rows of n contiguous")
    if d.device != tb.device:
        raise ValueError(f"{name}: tensors and tables on different devices")


@functools.lru_cache(maxsize=64)
def _galois_operands(elements: tuple[int, ...], n: int,
                     device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The Galois elements and their inverses g^-1 mod 2n as int32 tensors
    on the card, built once per (elements, n, device)."""
    hs = tuple(pow(g, -1, 2 * n) for g in elements)
    return (torch.tensor(elements, dtype=torch.int32, device=device),
            torch.tensor(hs, dtype=torch.int32, device=device))


def _check_elements(elements, n: int, count: int, name: str) -> tuple[int, ...]:
    elements = tuple(int(g) for g in elements)
    if len(elements) != count or not all(0 < g < 2 * n and g % 2 for g in elements):
        raise ValueError(f"{name}: need {count} odd Galois elements in (0, {2 * n}), "
                         f"got {elements}")
    return elements


def _check_rows(x: torch.Tensor, shape: tuple, device, name: str, what: str) -> None:
    """x an int32 tensor of the given shape on device, rows of n contiguous."""
    if x.dtype != torch.int32 or tuple(x.shape) != shape or x.stride(-1) != 1:
        raise ValueError(f"{name}: {what} must be an int32 {list(shape)} tensor with rows "
                         f"of n contiguous, got {x.dtype} {list(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: {what} on {x.device}, tables on {device}")


def _keyswitch_launch(d: torch.Tensor, keys_t: torch.Tensor, tb: NTTTables,
                      lane: int, name: str, g: int = 0,
                      c0: torch.Tensor | None = None) -> torch.Tensor:
    """One launch over d [kd, B, n] or prereduced [k, kd, B, n] (rows
    contiguous): [k, 2, B, n].  The kernel reads each key row with 16-byte
    loads, so keys_t must start 16-byte aligned with strides of whole
    16-byte words.  lane 0 classic, 1 prereduced, 2 Galois (element g, c0
    [k, B, n]), as the C entry point numbers them."""
    check_barrett(tb, name)
    check_aligned_tables(tb, name)
    kd, batch, n = d.shape[-3:]
    geo = keyswitch_geometry(n, tb.k, kd, batch, name, galois=lane == 2)
    if keys_t.data_ptr() % 16 or keys_t.stride(0) % 4 or keys_t.stride(1) % 4:
        raise ValueError(f"{name}: keys_t rows are not 16-byte aligned")
    out = torch.empty((tb.k, 2, batch, n), dtype=torch.int32, device=d.device)
    d_sp = d.stride(0) if lane == 1 else 0
    if lane == 2:
        h = pow(g, -1, 2 * n)
        c0_args = (_build.ptr(c0), c0.stride(0), c0.stride(1))
        vec = aligned(d, d.stride(0), d.stride(1)) and aligned(c0, c0.stride(0), c0.stride(1))
    else:
        h, c0_args, vec = 0, (None, 0, 0), False
    p = _build.ptr
    _build.launch(_lib().fhe_keyswitch, name, d.device, p(d), d_sp, d.stride(-3),
                  d.stride(-2), p(keys_t), keys_t.stride(0), keys_t.stride(1),
                  p(out), *table_ptrs(tb), tb.k, kd, batch, log2_exact(n),
                  geo["pairs"], geo["threads"], geo["smem"], lane, h, *c0_args, int(vec))
    return out


def _count(fn, prereduced: bool, g: int | None = None) -> None:
    if g is not None:
        fn.galois_launches += 1
    elif prereduced:
        fn.prereduced_launches += 1
    else:
        fn.launches += 1


def _check_galois_lane(d: torch.Tensor, tb: NTTTables, prereduced: bool,
                       g: int | None, c0: torch.Tensor | None, name: str) -> None:
    """The Galois lane takes classic digits of every prime (kd = k), one
    Galois element and c0 [k, B, n]."""
    if g is None:
        if c0 is not None:
            raise ValueError(f"{name}: c0 is given only with a Galois element g")
        return
    kd, batch, n = d.shape
    if prereduced or kd != tb.k:
        raise ValueError(f"{name}: the Galois lane takes the classic digits of all "
                         f"{tb.k} primes, got prereduced={prereduced}, kd={kd}")
    _check_elements((g,), n, 1, name)
    if c0 is None:
        raise ValueError(f"{name}: the Galois lane needs c0")
    _check_rows(c0, (tb.k, batch, n), tb.device, name, "c0")


def keyswitch_fused(d: torch.Tensor, keys_t: torch.Tensor, tb: NTTTables,
                    prereduced: bool = False, g: int | None = None,
                    c0: torch.Tensor | None = None) -> torch.Tensor:
    """Key-switch correction INTT(sum_j NTT([d_j]_{p_i}) ⊙ key[i, j, c]),
    c = 0, 1: d the [kd, n] gadget digits (digit j a residue mod its own
    q_j), keys_t the [k, kd, 2, n] NTT-form keys, prime-major.  keys_t may
    be a view with its last two dimensions contiguous (the stored
    [digit, prime, 2, n] keys permuted): the kernel reads it in place.
    ``prereduced=True`` takes d as [k, kd, n], digit j's residue mod each
    prime (the grouped gadget digits of ks_omega > 1), and skips the
    reduction.  With a Galois element ``g`` and c0 [k, n] (rows
    contiguous), the Galois lane: d holds the digits of the un-permuted c1
    (kd = k), and the result is the rotated ciphertext
    (phi_g(c0) + delta0, delta1) of phi_g then the key switch, in one
    launch.  Returns [k, 2, n]; every prime must be a 30-bit prime
    (Barrett).  Launches count in ``launches``, ``prereduced_launches`` and
    ``galois_launches`` by lane."""
    c0b = None if c0 is None else c0[:, None]
    _check_digits(d.unsqueeze(-2), tb, prereduced, "keyswitch_fused")
    _check_keys(keys_t, d.shape[-2], tb, "keyswitch_fused")
    _check_galois_lane(d.unsqueeze(-2), tb, prereduced, g, c0b, "keyswitch_fused")
    if not on_card(d, "keyswitch_fused"):
        return _ntt.keyswitch_fused(d, keys_t, tb, prereduced, g, c0)
    out = _keyswitch_launch(d.unsqueeze(-2), keys_t, tb,
                            2 if g is not None else int(prereduced), "keyswitch_fused",
                            g or 0, c0b)
    _count(keyswitch_fused, prereduced, g)
    return out[:, :, 0]


keyswitch_fused.launches = 0
keyswitch_fused.prereduced_launches = 0
keyswitch_fused.galois_launches = 0


def keyswitch_fused_batch(d: torch.Tensor, keys_t: torch.Tensor, tb: NTTTables,
                          prereduced: bool = False, g: int | None = None,
                          c0: torch.Tensor | None = None) -> torch.Tensor:
    """``keyswitch_fused`` for B digit stacks against one key set: d
    [kd, B, n] (digit-major, rows of n contiguous), or [k, kd, B, n] with
    ``prereduced``; keys_t [k, kd, 2, n] as in ``keyswitch_fused``; with
    ``g``, the same automorphism on every element and c0 [k, B, n] (rows
    contiguous: a view of a [B, k, 2, n] stack is read in place); one
    launch of B * k clusters; returns [k, 2, B, n], slice b equal to
    ``keyswitch_fused`` of element b's digits.  Launches count as in
    ``keyswitch_fused``."""
    _check_digits(d, tb, prereduced, "keyswitch_fused_batch")
    _check_keys(keys_t, d.shape[-3], tb, "keyswitch_fused_batch")
    _check_galois_lane(d, tb, prereduced, g, c0, "keyswitch_fused_batch")
    if not on_card(d, "keyswitch_fused_batch"):
        return _ntt.keyswitch_fused_batch(d, keys_t, tb, prereduced, g, c0)
    out = _keyswitch_launch(d, keys_t, tb, 2 if g is not None else int(prereduced),
                            "keyswitch_fused_batch", g or 0, c0)
    _count(keyswitch_fused_batch, prereduced, g)
    return out


keyswitch_fused_batch.launches = 0
keyswitch_fused_batch.prereduced_launches = 0
keyswitch_fused_batch.galois_launches = 0


def _check_ks_inner(dg: torch.Tensor, keys: torch.Tensor, tb: NTTTables,
                    name: str) -> None:
    """dg [k, kd, S, n] and keys [k, kd, E, 2, n], int32 on tb's device; rows
    of dg and each key's [2, n] block contiguous."""
    k, n = tb.k, tb.n
    if dg.dtype != torch.int32 or keys.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 residues")
    if dg.dim() != 4 or dg.shape[0] != k or dg.shape[3] != n or dg.stride(3) != 1:
        raise ValueError(f"{name}: digits {list(dg.shape)}, expected [{k}, kd, S, "
                         f"{n}] with rows of n contiguous")
    if (keys.dim() != 5 or keys.shape[:2] != dg.shape[:2]
            or keys.shape[3:] != (2, n) or keys.stride()[3:] != (n, 1)):
        raise ValueError(f"{name}: keys {list(keys.shape)}, expected "
                         f"[{k}, {dg.shape[1]}, E, 2, {n}] with each [2, n] block "
                         "contiguous")
    if dg.device != tb.device or keys.device != tb.device:
        raise ValueError(f"{name}: tensors and tables on different devices")


def _ks_inner_launch(dg: torch.Tensor, keys: torch.Tensor, tb: NTTTables,
                     batch: int, dg_div: int, key_mod: int, name: str,
                     elements: tuple[int, ...] | None = None,
                     c0: torch.Tensor | None = None) -> torch.Tensor:
    """One launch of 2 * batch * k clusters; element b reads digit stack
    b // dg_div (through stride 0 when there is one stack) and key set
    b % key_mod.  With the key sets' Galois ``elements`` and c0 (of stack
    b // dg_div, stride 0 when shared) a Galois lane: c0 staged in shared
    memory where it fits (``ks_inner_geometry``), else read in place.  Rows
    that do not all start 16-byte aligned are read a word at a time."""
    check_barrett(tb, name)
    check_aligned_tables(tb, name)
    kd, n = dg.shape[1], tb.n
    out = torch.empty((tb.k, 2, batch, n), dtype=torch.int32, device=dg.device)
    if batch == 0:
        return out
    geo = ks_inner_geometry(n, tb.k, batch, name, c0=elements is not None)
    dg_sb = dg.stride(2) if dg.shape[2] > 1 else 0
    vec = aligned(dg, dg.stride(0), dg.stride(1), dg_sb) and aligned(keys, *keys.stride()[:3])
    p = _build.ptr
    if elements is not None:
        gs, hs = _galois_operands(elements, n, dg.device)
        c0_ss = c0.stride(1) if c0.dim() == 3 and c0.shape[1] > 1 else 0
        if geo["stage_c0"]:
            vec = vec and aligned(c0, c0.stride(0), c0_ss)
        galois_args = (1 if geo["stage_c0"] else 2, p(gs), p(hs), p(c0), c0.stride(0), c0_ss)
    else:
        galois_args = (0, None, None, None, 0, 0)
    _build.launch(_lib().fhe_ks_inner, name, dg.device, p(dg), dg.stride(0),
                  dg.stride(1), dg_sb, dg_div, p(keys), keys.stride(0), keys.stride(1),
                  keys.stride(2), key_mod, p(out), p(tb.p), p(tb.mu), p(tb.ipsi_br),
                  p(tb.ipsi_br_shoup), p(tb.n_inv), p(tb.n_inv_shoup), tb.k, kd, batch,
                  log2_exact(n), geo["threads"], geo["smem"], int(vec), *galois_args)
    return out


def _check_c0(c0: torch.Tensor | None, stacks: tuple[int, ...], tb: NTTTables,
              name: str) -> None:
    """c0 [k, n] (shared) or [k, S, n] with S one of ``stacks``, rows of n
    contiguous."""
    if c0 is None:
        raise ValueError(f"{name}: the Galois lane needs c0")
    k, n = tb.k, tb.n
    if c0.dim() == 2:
        _check_rows(c0, (k, n), tb.device, name, "c0")
    else:
        if c0.dim() != 3 or c0.shape[1] not in stacks:
            raise ValueError(f"{name}: c0 {list(c0.shape)}, expected [{k}, {n}] or "
                             f"[{k}, S, {n}] with S in {stacks}")
        _check_rows(c0, (k, c0.shape[1], n), tb.device, name, "c0")


def ks_inner_batch(dg: torch.Tensor, keys: torch.Tensor,
                   tb: NTTTables, elements=None,
                   c0: torch.Tensor | None = None) -> torch.Tensor:
    """Hoisted key-switch inner product and inverse transform for B
    elements: out[i, c, b] = INTT(sum_j dg[i, j, b_dg] ⊙ keys[i, j, b, c]).

    dg:   [k, kd, B_dg, n] NTT-domain digits, rows of n contiguous; B_dg = B
          (one stack per element) or 1 (one stack shared by every element,
          read in place, not repeated: the hoisted rotations, whose
          per-element automorphism lives in the keys)
    keys: [k, kd, B, 2, n] per-element NTT-form keys, each [2, n] block
          contiguous
    Returns [k, 2, B, n]; every prime must be a 30-bit prime (Barrett); on
    the card 32 <= n <= 32768 (``ks_inner_geometry``).

    With the B Galois ``elements`` of the key sets and c0 ([k, n] shared,
    or [k, B, n]), the Galois lane: keys pre-permuted as
    ``hoisted_galois_keys`` makes them, element b is
    phi_{g_b}(correction + (c0, 0)), the hoisted rotation, gathered in the
    NTT domain before the inverse (c0 staged in shared memory up to
    n = 16384, read in place at n = 32768).  Launches count in
    ``launches`` and ``galois_launches`` by lane."""
    _check_ks_inner(dg, keys, tb, "ks_inner_batch")
    batch = keys.shape[2]
    if dg.shape[2] not in (1, batch):
        raise ValueError(f"ks_inner_batch: {dg.shape[2]} digit stacks for {batch} "
                         "elements; expected 1 or one per element")
    if elements is not None:
        elements = _check_elements(elements, tb.n, batch, "ks_inner_batch")
        _check_c0(c0, (batch,), tb, "ks_inner_batch")
    if not on_card(dg, "ks_inner_batch"):
        return _ntt.ks_inner_batch(dg, keys, tb, elements, c0)
    out = _ks_inner_launch(dg, keys, tb, batch, 1, batch, "ks_inner_batch", elements, c0)
    if elements is None:
        ks_inner_batch.launches += 1
    else:
        ks_inner_batch.galois_launches += 1
    return out


ks_inner_batch.launches = 0
ks_inner_batch.galois_launches = 0


def ks_inner_grouped(dg: torch.Tensor, keys: torch.Tensor,
                     tb: NTTTables, elements=None,
                     c0: torch.Tensor | None = None) -> torch.Tensor:
    """``ks_inner_batch`` of C digit stacks dg [k, kd, C, n] against E key
    sets keys [k, kd, E, 2, n] (the hoisted rotations of C ciphertexts):
    element b = c*E + e pairs stack c with key set e, through the kernel's
    index maps, so neither operand is repeated in memory.  Returns
    [k, 2, C*E, n].  With the E Galois ``elements`` and c0 [k, C, n] (one
    row per ciphertext), the Galois lane: element c*E + e is
    phi_{g_e}(correction + (c0_c, 0)).  Launches count in ``launches`` and
    ``galois_launches`` by lane."""
    _check_ks_inner(dg, keys, tb, "ks_inner_grouped")
    num_c, num_e = dg.shape[2], keys.shape[2]
    if elements is not None:
        elements = _check_elements(elements, tb.n, num_e, "ks_inner_grouped")
        _check_c0(c0, (num_c,), tb, "ks_inner_grouped")
    if not on_card(dg, "ks_inner_grouped"):
        return _ntt.ks_inner_grouped(dg, keys, tb, elements, c0)
    out = _ks_inner_launch(dg, keys, tb, num_c * num_e, num_e, num_e,
                           "ks_inner_grouped", elements, c0)
    if elements is None:
        ks_inner_grouped.launches += 1
    else:
        ks_inner_grouped.galois_launches += 1
    return out


ks_inner_grouped.launches = 0
ks_inner_grouped.galois_launches = 0
