"""ctypes bindings for the native host runtime (``native/fhecore.cpp``) —
this package's own copy of ``fhe_tpu/utils/native.py``.

The C++ library speeds up the host-side number theory that runs when a
context is built (prime search, primitive roots, twiddle and Shoup table
generation).  Loading is lazy and optional: if the shared library is
missing, callers fall back to the pure-Python bodies in
``fhe_tpu_torch.primes`` and ``ops/ntt.py``; results are bit-identical
either way (tests/test_torch_utils.py).

Set ``FHE_TPU_NO_NATIVE=1`` to force the Python path; set
``FHE_TPU_AUTO_BUILD=0`` to forbid the one-time on-demand ``make`` build.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading

import numpy as np

_REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
_NATIVE_DIR = _REPO_ROOT / "native"
_CANDIDATES = (
    _NATIVE_DIR / "libfhecore.so",
    _NATIVE_DIR / "build" / "libfhecore.so",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _try_build() -> None:
    if os.environ.get("FHE_TPU_AUTO_BUILD", "1") == "0":
        return
    # Never spawn a compiler into a read-only install (CI images, site-packages
    # with restricted perms): building writes .o/.so files into native/.
    if not os.access(_NATIVE_DIR, os.W_OK):
        return
    import logging
    logging.getLogger(__name__).info(
        "building native fhecore library in %s (set FHE_TPU_AUTO_BUILD=0 "
        "to disable)", _NATIVE_DIR)
    try:
        subprocess.run(
            ["make", "-C", str(_NATIVE_DIR), "libfhecore.so"],
            capture_output=True, timeout=120, check=False)
    except (OSError, subprocess.TimeoutExpired):
        pass


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("FHE_TPU_NO_NATIVE") == "1":
            return None
        if not any(p.exists() for p in _CANDIDATES):
            _try_build()
        for path in _CANDIDATES:
            if not path.exists():
                continue
            try:
                lib = ctypes.CDLL(str(path))
                _bind(lib)  # AttributeError on stale/partial ABI -> skip
                if lib.fhe_version() < 1:
                    continue
            except (OSError, AttributeError):
                continue
            _lib = lib
            break
        return _lib


def _bind(lib: ctypes.CDLL) -> None:
    u64 = ctypes.c_uint64
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.fhe_is_prime.restype = ctypes.c_int
    lib.fhe_is_prime.argtypes = [u64]
    lib.fhe_pow_mod.restype = u64
    lib.fhe_pow_mod.argtypes = [u64, u64, u64]
    lib.fhe_mod_inverse.restype = u64
    lib.fhe_mod_inverse.argtypes = [u64, u64]
    lib.fhe_find_ntt_primes.restype = ctypes.c_int
    lib.fhe_find_ntt_primes.argtypes = [u64, ctypes.c_int, ctypes.c_int,
                                        u64p, ctypes.c_int, u64p]
    lib.fhe_primitive_root.restype = u64
    lib.fhe_primitive_root.argtypes = [u64]
    lib.fhe_root_of_unity.restype = u64
    lib.fhe_root_of_unity.argtypes = [u64, u64]
    lib.fhe_negacyclic_psi.restype = u64
    lib.fhe_negacyclic_psi.argtypes = [u64, u64]
    lib.fhe_build_ntt_tables.restype = ctypes.c_int
    lib.fhe_build_ntt_tables.argtypes = [u64, u64, u32p, u32p, u32p, u32p,
                                         u32p, u32p]
    lib.fhe_version.restype = ctypes.c_int
    lib.fhe_version.argtypes = []


def available() -> bool:
    """True iff the native library is loaded (or loadable)."""
    return _load() is not None


# -- wrappers (None-returning contract: caller falls back to Python) ----------


def is_prime(n: int) -> bool | None:
    lib = _load()
    if lib is None or n >= 1 << 63:
        return None
    return bool(lib.fhe_is_prime(n))


def find_ntt_primes(n: int, count: int, bits: int,
                    exclude: tuple[int, ...]) -> list[int] | None:
    lib = _load()
    # bits >= 32 would overflow the C path's u32 outputs (and 1<<64 is UB);
    # let the arbitrary-precision Python fallback handle it
    if lib is None or not (2 <= bits <= 31):
        return None
    excl = np.asarray(exclude, dtype=np.uint64)
    out = np.zeros(count, dtype=np.uint64)
    rc = lib.fhe_find_ntt_primes(
        n, count, bits,
        excl.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(exclude),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    if rc != 0:
        raise ValueError(
            f"not enough {bits}-bit NTT primes for n={n}, count={count}")
    return [int(p) for p in out]


def negacyclic_psi(n: int, p: int) -> int | None:
    lib = _load()
    if lib is None:
        return None
    psi = lib.fhe_negacyclic_psi(n, p)
    return int(psi) if psi else None


def build_ntt_tables(n: int, p: int):
    """Returns (psi_br, psi_br_shoup, ipsi_br, ipsi_br_shoup, n_inv,
    n_inv_shoup) as numpy arrays/ints, or None when unavailable."""
    lib = _load()
    if lib is None or p >= 1 << 32:   # u32 table entries would truncate
        return None
    u32p = ctypes.POINTER(ctypes.c_uint32)
    tabs = [np.empty(n, dtype=np.uint32) for _ in range(4)]
    n_inv = ctypes.c_uint32()
    n_inv_sh = ctypes.c_uint32()
    rc = lib.fhe_build_ntt_tables(
        n, p, *(t.ctypes.data_as(u32p) for t in tabs),
        ctypes.byref(n_inv), ctypes.byref(n_inv_sh))
    if rc != 0:
        return None
    return (*tabs, int(n_inv.value), int(n_inv_sh.value))
