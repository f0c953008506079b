"""Key / ciphertext (de)serialization — counterpart of
``fhe_tpu/utils/serialize.py``, in the same file format, so that a file
written by either package loads in the other.

Format (version 1): one ``.npz`` holding the residue arrays as uint32 under
``name/data`` (``name/g{g}`` per Galois element, ``name/pos`` and
``name/neg`` for a bootstrap key), and a ``__header__`` entry, the UTF-8
bytes of a JSON object {"version": 1, "entries": {name: meta}} with each
object's type and static fields (level, is_ntt_form, noise_budget, scale_t
as an int; SchemeParams as its fields).

    save(path, {"pk": pk, "sk": sk, "ct": ct})
    objs = load(path, device="cuda")      # objs["ct"] is a Ciphertext again
"""

from __future__ import annotations

import dataclasses
import json
import typing as _t

import numpy as np
import torch

from ..ops.modmath import resolve_device
from ..params import SchemeParams, SecurityParams
from ..scheme.types import (BootstrapKey, Ciphertext, GaloisKeys, Plaintext, PublicKey,
                            RelinKeys, SecretKey)

FORMAT_VERSION = 1

# type tag -> (class, static metadata fields)
_TYPES: dict[str, tuple[type, tuple[str, ...]]] = {
    "Plaintext": (Plaintext, ("is_ntt_form",)),
    "Ciphertext": (Ciphertext, ("level", "is_ntt_form", "noise_budget", "scale_t")),
    "PublicKey": (PublicKey, ()),
    "SecretKey": (SecretKey, ()),
    "RelinKeys": (RelinKeys, ()),
    "GaloisKeys": (GaloisKeys, ()),
}
_CLS_TO_TAG = {cls: tag for tag, (cls, _) in _TYPES.items()}


def _params_to_meta(params: SchemeParams) -> dict:
    return {
        "type": "SchemeParams",
        "security": dataclasses.asdict(params.security),
        "q_primes": list(params.q_primes),
        "aux_primes": list(params.aux_primes),
        "m_sk": params.m_sk, "gamma": params.gamma,
        "m_tilde": params.m_tilde, "n": params.n, "t": params.t,
    }


def _params_from_meta(meta: dict) -> SchemeParams:
    return SchemeParams(
        security=SecurityParams(**meta["security"]),
        n=meta["n"], t=meta["t"],
        q_primes=tuple(meta["q_primes"]),
        aux_primes=tuple(meta["aux_primes"]),
        m_sk=meta["m_sk"], gamma=meta["gamma"], m_tilde=meta["m_tilde"],
    )


def _u32(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().view(np.uint32)


def _tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.uint32).view(np.int32)
                            ).to(device)


def _flatten(name: str, obj) -> tuple[dict[str, np.ndarray], dict]:
    if isinstance(obj, SchemeParams):
        return {}, _params_to_meta(obj)
    if isinstance(obj, BootstrapKey):
        return ({f"{name}/pos": _u32(obj.pos), f"{name}/neg": _u32(obj.neg)},
                {"type": "BootstrapKey", "meta": {"level": int(obj.level)}})
    tag = _CLS_TO_TAG.get(type(obj))
    if tag is None:
        raise TypeError(f"cannot serialize {type(obj).__name__!r}")
    _, meta_fields = _TYPES[tag]
    cast = {"level": int, "is_ntt_form": bool, "noise_budget": float, "scale_t": int}
    meta: dict = {"type": tag,
                  "meta": {f: cast[f](getattr(obj, f)) for f in meta_fields}}
    if tag == "GaloisKeys":
        meta["elements"] = sorted(int(g) for g in obj.data)
        return {f"{name}/g{g}": _u32(obj.data[g]) for g in meta["elements"]}, meta
    return {f"{name}/data": _u32(obj.data)}, meta


def _unflatten(name: str, meta: dict, npz, device: torch.device) -> _t.Any:
    if meta["type"] == "SchemeParams":
        return _params_from_meta(meta)
    if meta["type"] == "BootstrapKey":
        return BootstrapKey(pos=_tensor(npz[f"{name}/pos"], device),
                            neg=_tensor(npz[f"{name}/neg"], device),
                            level=meta["meta"]["level"])
    cls, _ = _TYPES[meta["type"]]
    if meta["type"] == "GaloisKeys":
        return cls(data={int(g): _tensor(npz[f"{name}/g{g}"], device)
                         for g in meta["elements"]})
    return cls(data=_tensor(npz[f"{name}/data"], device), **meta.get("meta", {}))


def save(path, objs: dict[str, _t.Any]) -> None:
    """Write a named collection of FHE objects to ``path`` (.npz)."""
    header: dict = {"version": FORMAT_VERSION, "entries": {}}
    arrays: dict[str, np.ndarray] = {}
    for name, obj in objs.items():
        if "/" in name:
            raise ValueError(f"object name may not contain '/': {name!r}")
        arrs, meta = _flatten(name, obj)
        arrays.update(arrs)
        header["entries"][name] = meta
    arrays["__header__"] = np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load(path, device="cuda") -> dict[str, _t.Any]:
    """Read back a collection written by :func:`save` (by this package or the
    JAX package), its tensors on ``device``."""
    dev = resolve_device(device)
    with np.load(path) as npz:
        header = json.loads(bytes(npz["__header__"]).decode())
        if header["version"] > FORMAT_VERSION:
            raise ValueError(f"file format v{header['version']} newer than supported "
                             f"v{FORMAT_VERSION}")
        return {name: _unflatten(name, meta, npz, dev)
                for name, meta in header["entries"].items()}
