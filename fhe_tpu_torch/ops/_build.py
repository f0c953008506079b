"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded through ``ctypes``.  All sources compile in
parallel, one ``nvcc`` each, on the first call to ``load``; the libraries go
into ``fhe_tpu_torch/_build/<hash>/``, where the hash covers every file in
``csrc/`` and the compiler flags, so an edited source rebuilds and an
unchanged one is reused.  A missing ``nvcc`` or a failed build raises: there
is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("ntt", "decrypt")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / _digest()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found is None and CUDA_HOME is not None:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        found = str(cand) if cand.exists() else None
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return found


def _build(out: Path) -> None:
    """Compile every source that has no library in ``out`` yet, all at once."""
    out.mkdir(parents=True, exist_ok=True)
    todo = [s for s in SOURCES if not (out / f"lib{s}.so").exists()]
    if not todo:
        return
    nvcc = _nvcc()
    procs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(prefix=f"lib{name}.", suffix=".so.tmp",
                                   dir=out)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        (out / f"{name}.log").write_text(log)
        if proc.returncode == 0:
            os.replace(tmp, out / f"lib{name}.so")
        else:
            os.unlink(tmp)
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


@functools.lru_cache(maxsize=None)
def _load_all() -> dict[str, ctypes.CDLL]:
    out = build_dir()
    _build(out)
    return {s: ctypes.CDLL(str(out / f"lib{s}.so")) for s in SOURCES}


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (builds all on first use)."""
    return _load_all()[name]


def load_all() -> None:
    """Build (if needed) and load every kernel library."""
    _load_all()


def launch(entry, what: str, device, *args) -> None:
    """Call a C entry point on ``device`` and its current stream (passed as
    the last argument); raise if it returns a nonzero ``cudaError_t``."""
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        rc = entry(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def ptr(x) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())
