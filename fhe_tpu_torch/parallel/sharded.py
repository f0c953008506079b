"""User-facing sharded-execution helpers — counterpart of ``fhe_tpu/parallel/sharded.py``.

Two production layouts:

* **rns** — the RNS prime axis across ranks: ``ShardedFHE.multiply`` runs
  the explicit BEHZ multiply of ``shard_scheme.py``, per-prime transforms
  rank-local, the base conversions' digits exchanged by all-gathers.
* **dp** — batch data-parallelism: independent ciphertexts per rank.

The port is SPMD (``mesh.py``): every rank runs the same calls on the same
global objects.  A sharded object is therefore the whole object on the
rank's device; which rows a rank computes is the layout's business
(``mesh.rns_sharding``), so ``shard`` places the object and checks that its
prime axis splits over the mesh axis.  Example, on every rank::

    mesh = make_mesh({"rns": 4})
    sfhe = ShardedFHE(fhe, mesh)
    ct1, ct2, rlk = sfhe.shard(ct1), sfhe.shard(ct2), sfhe.shard(rlk)
    out = sfhe.multiply(ct1, ct2, rlk)          # runs sharded, whole on every rank
"""

from __future__ import annotations

import dataclasses

import torch

from ..scheme.types import GaloisKeys, RelinKeys
from .mesh import Sharding, axis_size, replicated, rns_sharding


def _map_tensors(fn, obj):
    """obj with every tensor leaf replaced by fn(leaf): tensors, dataclasses
    (ciphertexts, keys) and lists, tuples and dicts of them."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(fn, o) for o in obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(fn, v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _map_tensors(fn, getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    return obj


class ShardedFHE:
    """Wraps an ``fhe_tpu_torch.FHE`` instance with a mesh; ``multiply``
    runs with the prime axis split over the ranks of ``axis`` (default
    ``rns``).

    ``multiply`` routes through the explicit sharded BEHZ path
    (parallel/shard_scheme.py) whenever the mesh has the axis, the scheme
    is BFV and the level's prime count divides over it, as the JAX
    package's ShardedFHE does; otherwise every rank runs the wrapped
    multiply on the whole ciphertexts."""

    def __init__(self, fhe, mesh, axis: str = "rns"):
        self.fhe = fhe
        self.mesh = mesh
        self.axis = axis

    def multiply(self, a, b, rlk):
        """Ciphertext multiply + relinearize, explicit-collective path when
        eligible (BFV, axis in the mesh, (k - level) % P == 0); the wrapped
        FHE's multiply otherwise."""
        from . import shard_scheme as _ss
        level = a.level
        eligible = (
            self.axis in (self.mesh.mesh_dim_names or ())
            and getattr(self.fhe, "scheme_name", "bfv") == "bfv"
            and (self.fhe.ctx.k - level) % axis_size(self.mesh, self.axis) == 0)
        if not eligible:
            return self.fhe.multiply(a, b, rlk)
        with self.fhe.monitor.time("multiply_shardmap"):
            return _ss.multiply_relin_shardmap(
                self.fhe.ctx, a, b, rlk, self.mesh, self.axis)

    def shard(self, obj):
        """Place any key/ciphertext object — or a container of them — on
        this rank with its prime axis split over ``axis``: axis 1 of the
        digit-major keys (RelinKeys, GaloisKeys: [k_digit, k, 2, n]), axis 0
        of everything else.  Dispatches on the object type, so key material
        nested in tuples/dicts keeps the digit-axis-aware layout.  Raises
        where a prime axis does not split evenly."""
        if isinstance(obj, (list, tuple)):
            return type(obj)(self.shard(o) for o in obj)
        if isinstance(obj, dict):
            return {k: self.shard(v) for k, v in obj.items()}
        digit_major = isinstance(obj, (RelinKeys, GaloisKeys))

        def place(leaf: torch.Tensor) -> torch.Tensor:
            if leaf.dim() == 0:
                return leaf
            if digit_major:
                return Sharding(self.mesh, (None, self.axis)).place(leaf)
            return rns_sharding(self.mesh, leaf.dim(), self.axis).place(leaf)
        return _map_tensors(place, obj)

    def replicate(self, obj):
        return _map_tensors(replicated(self.mesh).place, obj)

    # every other op passes through to the wrapped FHE on every rank
    def __getattr__(self, name):
        return getattr(self.fhe, name)


def shard_batch(mesh, stacked: torch.Tensor, axis: str = "dp") -> torch.Tensor:
    """Place a [B, ...] stack of ciphertext tensors batch-sharded: the whole
    stack on this rank, B split over ``axis`` (raises unless it divides);
    ``rns_sharding(mesh, stacked.dim(), axis).local(stacked)`` is the rank's
    block of ciphertexts."""
    return rns_sharding(mesh, stacked.dim(), axis).place(stacked)
