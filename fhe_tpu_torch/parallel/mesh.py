"""Device mesh, layouts and collectives — counterpart of ``fhe_tpu/parallel/mesh.py``.

The JAX package is single-controller: one program places global arrays on a
``jax.sharding.Mesh`` and ``shard_map`` runs each device's block.  This port
is SPMD on ``torch.distributed``: one process per rank, every rank running
the same calls on the same global arrays, each computing its own block and
exchanging blocks through the collectives below.  The scalable axes are
those of the JAX package:

  * ``rns``   — the RNS prime axis (``shard_scheme.py``),
  * ``coeff`` — polynomial-coefficient blocks (``distributed_ntt.py``),
  * ``dp``    — independent ciphertexts (``sharded.shard_batch``).

A ``Sharding`` is the layout of one tensor (JAX's ``NamedSharding``): which
block of each dimension a rank holds.  The collectives take the mesh and an
axis name where the JAX code names the axis inside ``shard_map``; each
counts its calls in ``<function>.calls``, as the kernel wrappers count their
launches.  On a gloo process group a CUDA tensor goes through a host copy,
explicitly, both ways: gloo's point-to-point calls take no CUDA tensors, and
the helpers stage every gloo collective the same way.  The computation stays
on the tensor's device; no other backend is staged, and a failed collective
raises.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..ops.modmath import resolve_device


def make_mesh(axes: dict[str, int] | None = None, devices=None) -> DeviceMesh:
    """Mesh from {'axis': size} over the default process group, which the
    caller has initialised (``torch.distributed.init_process_group``), with
    ``mesh_dim_names`` the axes in order; default: every rank on the 'rns'
    axis.  The mesh's size must equal the world size.  ``devices`` is the
    ranks' device type: the card ("cuda", the default, which raises without
    one) or "cpu"."""
    dev = resolve_device("cuda" if devices is None else devices)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process group")
    world = dist.get_world_size()
    if axes is None:
        axes = {"rns": world}
    n = math.prod(axes.values())
    if n != world:
        raise ValueError(f"mesh needs {n} ranks, the process group has {world}")
    return init_device_mesh(dev.type, tuple(axes.values()), mesh_dim_names=tuple(axes))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Ranks along ``axis`` (JAX's ``mesh.shape[axis]``); raises for an axis
    the mesh does not have."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors live on: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A tensor's layout over a mesh, as a ``PartitionSpec`` names it:
    ``spec[d]`` is the mesh axis whose ranks split dimension d into equal
    blocks (in axis order), None or a missing entry replicates it."""

    mesh: DeviceMesh
    spec: tuple[str | None, ...] = ()

    def _blocks(self, x: torch.Tensor):
        for d, axis in enumerate(self.spec):
            if axis is None:
                continue
            size = axis_size(self.mesh, axis)
            if x.shape[d] % size:
                raise ValueError(f"dimension {d} of a {list(x.shape)} tensor does not split "
                                 f"into {size} equal blocks over mesh axis {axis!r}")
            yield d, axis, x.shape[d] // size

    def place(self, x: torch.Tensor) -> torch.Tensor:
        """The whole of x on this rank's device (``jax.device_put``): every
        rank holds the global tensor, and ``local`` names the block it
        computes.  Raises unless every sharded dimension splits evenly."""
        for _ in self._blocks(x):
            pass
        return x.to(mesh_device(self.mesh))

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global tensor x (a view)."""
        for d, axis, block in self._blocks(x):
            x = x.narrow(d, axis_index(self.mesh, axis) * block, block)
        return x


def rns_sharding(mesh: DeviceMesh, ndim: int, axis: str = "rns") -> Sharding:
    """Shard the leading (prime) axis of a [k, ..., n] residue tensor."""
    return Sharding(mesh, (axis,) + (None,) * (ndim - 1))


def replicated(mesh: DeviceMesh) -> Sharding:
    return Sharding(mesh)


# ---------------------------------------------------------------------------
# collectives (each counts its calls in <function>.calls)
# ---------------------------------------------------------------------------


def _staged(x: torch.Tensor, group) -> torch.Tensor:
    """x as the group's backend takes it: a host copy of a CUDA tensor for
    gloo, x itself (contiguous) otherwise."""
    if x.device.type == "cuda" and dist.get_backend(group) == "gloo":
        return x.cpu()
    return x.contiguous()


def _gather(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int) -> torch.Tensor:
    group = mesh.get_group(axis)
    send = _staged(x, group)
    parts = [torch.empty_like(send) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, send, group=group)
    return torch.cat(parts, dim).to(x.device)


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int = 0) -> torch.Tensor:
    """Every rank's block x along ``axis``, concatenated along ``dim`` in
    axis order (``lax.all_gather(x, axis, axis=dim, tiled=True)``)."""
    out = _gather(x, mesh, axis, dim)
    all_gather.calls += 1
    return out


all_gather.calls = 0


def assemble(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The global result from every rank's block along ``dim`` (what
    ``shard_map``'s ``out_specs`` gives a JAX caller): one all-gather,
    counted here, apart from an algorithm's own exchanges."""
    out = _gather(x, mesh, axis, dim)
    assemble.calls += 1
    return out


assemble.calls = 0


def exchange(x: torch.Tensor, mesh: DeviceMesh, axis: str, partner: int) -> torch.Tensor:
    """Send x to the rank at coordinate ``partner`` along ``axis`` and
    return that rank's x: one ``batch_isend_irecv`` pair, a pairwise
    ``lax.ppermute``."""
    group = mesh.get_group(axis)
    peer = dist.get_global_rank(group, partner)
    send = _staged(x, group)
    recv = torch.empty_like(send)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, peer, group),
                                       dist.P2POp(dist.irecv, recv, peer, group)]):
        req.wait()
    exchange.calls += 1
    return recv.to(x.device)


exchange.calls = 0


def psum(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """The exact sum over ``axis`` of every rank's x (``lax.psum``): one
    all-reduce; the caller keeps the sum inside x's dtype."""
    group = mesh.get_group(axis)
    buf = _staged(x, group).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    psum.calls += 1
    return buf.to(x.device)


psum.calls = 0

COLLECTIVES = (all_gather, assemble, exchange, psum)


def collective_counts() -> dict[str, int]:
    return {fn.__name__: fn.calls for fn in COLLECTIVES}


def reset_collective_counts() -> None:
    for fn in COLLECTIVES:
        fn.calls = 0
