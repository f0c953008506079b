"""Runtime residue checks — counterpart of ``fhe_tpu/utils/debug.py``.

``checked(fn)`` wraps a scheme function so that every residue tensor it
returns is range-checked against its prime: a residue >= p means a
reduction bug upstream.  The JAX package stages its check into the traced
program (checkify); here the op runs eagerly and the check is one more
comparison on the tensor's device, read back once.
"""

from __future__ import annotations

import dataclasses
import functools

import torch


def assert_residues_in_range(x: torch.Tensor, p: torch.Tensor, name: str = "residues"):
    """Raise ValueError unless every value of the [k, ...] residues x is below
    its prime p[i].  int32 residues are read as the uint32 the kernels see, so
    a negative int32 counts as a residue of 2^31 or more."""
    x64 = x.to(torch.int64) & 0xFFFFFFFF
    pb = p.to(device=x.device, dtype=torch.int64).reshape((p.shape[0],) + (1,) * (x.dim() - 1))
    bad = x64 >= pb
    if bool(bad.any()):
        idx = tuple(int(v) for v in bad.nonzero()[0])
        raise ValueError(f"{name}: residue out of range [0, p): {int(x64[idx])} at "
                         f"{list(idx)} >= p = {int(p[idx[0]])}")


def tensor_leaves(obj) -> list:
    """The tensors in obj: a tensor, a dataclass (a ciphertext or key), or a
    list, tuple or dict of those."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [t for f in dataclasses.fields(obj) for t in tensor_leaves(getattr(obj, f.name))]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in tensor_leaves(v)]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in tensor_leaves(v)]
    return []


def checked(fn, primes_getter=None):
    """Wrap fn so that its int32 outputs of k rows (k primes) are checked
    with ``assert_residues_in_range``.  primes_getter(args, kwargs) -> [k]
    primes; by default the first argument's ``ntt_q.p`` (a SchemeContext).
    The wrapper has fn's signature and raises ValueError on the first
    residue out of range."""
    if primes_getter is None:
        def primes_getter(args, kwargs):
            return args[0].ntt_q.p

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        p = primes_getter(args, kwargs)
        out = fn(*args, **kwargs)
        for leaf in tensor_leaves(out):
            if leaf.dtype == torch.int32 and leaf.dim() >= 1 and leaf.shape[0] == p.shape[0]:
                assert_residues_in_range(leaf, p, name=fn.__name__)
        return out

    return wrapper
