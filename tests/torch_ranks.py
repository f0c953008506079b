"""Rank programs of the sharded tests (tests/test_torch_parallel.py,
test_torch_shard_scheme.py, test_torch_dist_ntt.py and the card's
tests/test_torch_cuda.py).

Each function runs in every rank of a world that
``fhe_tpu_torch.parallel.launch`` starts, on the inputs the test passes as
numpy arrays (the JAX package's keys and ciphertexts), and returns numpy
arrays and plain values for the test to hold against the JAX functions.
This file imports torch and fhe_tpu_torch only; every program reports the
JAX modules its process has loaded, which the tests require to be none.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist

from fhe_tpu_torch import FHE, convert
from fhe_tpu_torch.ops import modmath as mm
from fhe_tpu_torch.ops import ntt as tntt
from fhe_tpu_torch.parallel import distributed_ntt as dntt
from fhe_tpu_torch.parallel import mesh as M
from fhe_tpu_torch.parallel import shard_scheme
from fhe_tpu_torch.parallel.sharded import ShardedFHE, shard_batch
from fhe_tpu_torch.params import SecurityParams, make_scheme_params
from fhe_tpu_torch.scheme import bfv
from fhe_tpu_torch.scheme.context import make_context
from fhe_tpu_torch.scheme.types import Ciphertext, RelinKeys

PSUM_PRIME = 1073479681   # a 30-bit NTT prime


def _jax_loaded() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "fhe_tpu"))


def _raises(fn) -> str | None:
    """The ValueError or RuntimeError fn() raises, as text; None if none."""
    try:
        fn()
    except (ValueError, RuntimeError) as exc:
        return f"{type(exc).__name__}: {exc}"
    return None


def _state(inp: dict, device: str):
    """The port's FHE at the inputs' parameters, and the JAX package's
    keys and ciphertexts carried across."""
    fhe = FHE(make_scheme_params(SecurityParams(**inp["kw"])), device=device)
    pk, sk = convert.keys_from_numpy(inp["pk"], inp["sk"], device)
    rlk = convert.relin_keys_from_numpy(inp["rlk"], device)
    cts = [convert.ciphertext_from_numpy(c["data"], c["level"], c["ntt"], c["budget"], device)
           for c in inp["cts"]]
    return fhe, pk, sk, rlk, cts


def _ct(fhe: FHE, ct: Ciphertext, sk) -> dict:
    return dict(data=convert.to_numpy(ct), level=ct.level, ntt=ct.is_ntt_form,
                budget=ct.noise_budget, decoded=[int(v) for v in fhe.decode(fhe.decrypt(ct, sk))[:3]])


def _counted(fn):
    """fn()'s result and the collectives it made."""
    M.reset_collective_counts()
    out = fn()
    return out, M.collective_counts()


def parallel_world(inp: dict) -> dict:
    """test_torch_parallel.py: the rns multiply at k = 4 over the world (2
    or 4 ranks), ShardedFHE (4 ranks; 3 ranks: the wrapped multiply),
    shard, the psum key switch and psum_mod, the dp layout, the mesh's
    errors; 3 ranks also the non-power-of-two coeff axis."""
    world = dist.get_world_size()
    fhe, pk, sk, rlk, (a, b) = _state(inp, "cpu")
    ctx = fhe.ctx
    mesh = M.make_mesh({"rns": world}, "cpu")
    res = {}
    if world == 3:
        out, res["routed_counts"] = _counted(lambda: ShardedFHE(fhe, mesh).multiply(a, b, rlk))
        res["routed"] = _ct(fhe, out, sk)
        res["routed_monitor"] = fhe.monitor.get_stats().counts.get("multiply_shardmap", 0)
        res["coeff_3"] = _raises(lambda: dntt.make_distributed_polymul(
            M.make_mesh({"coeff": 3}, "cpu"), ctx.ntt_q, ctx.n))
        res["jax_loaded"] = _jax_loaded()
        return res
    out, res["counts"] = _counted(
        lambda: shard_scheme.multiply_relin_shardmap(ctx, a, b, rlk, mesh))
    res["shardmap"] = _ct(fhe, out, sk)
    res["single"] = _ct(fhe, bfv.multiply(ctx, a, b, rlk), sk)
    res["level_mismatch"] = _raises(lambda: shard_scheme.multiply_relin_shardmap(
        ctx, fhe.mod_switch_to_next(a), b, rlk, mesh))
    if world == 2:
        fhe3 = FHE(make_scheme_params(SecurityParams(**inp["kw3"])), seed=3, device="cpu")
        pk3, sk3 = fhe3.keygen()
        c3 = fhe3.encrypt(fhe3.encode([1]), pk3)
        res["uneven"] = _raises(lambda: shard_scheme.multiply_relin_shardmap(
            fhe3.ctx, c3, c3, fhe3.relinkey_gen(sk3), mesh))
        res["jax_loaded"] = _jax_loaded()
        return res
    # world 4: ShardedFHE, shard, psum key switch, psum_mod, dp, mesh errors
    sf = ShardedFHE(fhe, mesh)
    out, res["sharded_counts"] = _counted(
        lambda: sf.multiply(sf.shard(a), sf.shard(b), sf.shard(rlk)))
    res["sharded"] = _ct(fhe, out, sk)
    res["sharded_monitor"] = fhe.monitor.get_stats().counts.get("multiply_shardmap", 0)
    bundle = sf.shard({"rlk": rlk, "pair": (pk, sk)})
    res["bundle_same"] = (isinstance(bundle["pair"], tuple)
                          and torch.equal(bundle["rlk"].data, sf.shard(rlk).data)
                          and torch.equal(bundle["pair"][0].data, sf.shard(pk).data)
                          and torch.equal(bundle["pair"][1].data, sk.data))
    two_digits = rlk.data[:2]                     # [2 digits, 4 primes, 2, n]
    res["digit_axis"] = _raises(lambda: sf.shard(RelinKeys(data=two_digits)))
    res["prime_axis"] = _raises(lambda: sf.shard(Ciphertext(data=two_digits[:, 0])))
    poly = torch.from_numpy(inp["poly"].astype(np.int32))
    delta, res["psum_counts"] = _counted(
        lambda: shard_scheme.keyswitch_delta_psum(ctx, poly, rlk.data, mesh))
    res["psum_delta"] = convert.to_numpy(delta)
    res["psum_single"] = convert.to_numpy(bfv._keyswitch_delta(ctx, poly, rlk.data, 0))
    x = torch.full((4, 16), PSUM_PRIME - 1, dtype=torch.int32)
    res["psum_mod"] = convert.to_numpy(shard_scheme.psum_mod(
        x, PSUM_PRIME, mm.shoup_precompute(1 << 16, PSUM_PRIME), mesh, "rns"))
    res["mesh_size"] = _raises(lambda: M.make_mesh({"rns": 3}, "cpu"))
    res["mesh_default"] = None if torch.cuda.is_available() else _raises(
        lambda: M.make_mesh({"rns": world}))
    dmesh = M.make_mesh({"dp": world}, "cpu")
    stacks = [shard_batch(dmesh, torch.stack([c.data] * world)) for c in (a, b)]
    mine = [M.rns_sharding(dmesh, 4, "dp").local(s) for s in stacks]      # [1, k, 2, n]
    outs = bfv.multiply_batch(ctx, [a.replace(data=d) for d in mine[0]],
                              [b.replace(data=d) for d in mine[1]], rlk)
    prods = M.assemble(torch.stack([o.data for o in outs]), dmesh, "dp")
    sums = M.assemble(torch.stack([bfv.add(ctx, a.replace(data=d), a.replace(data=d)).data
                                   for d in mine[0]]), dmesh, "dp")
    res["dp_mul"] = [_ct(fhe, a.replace(data=d, noise_budget=outs[0].noise_budget), sk)
                     for d in prods]
    res["dp_add"] = [_ct(fhe, a.replace(data=d), sk)["decoded"] for d in sums]
    res["dp_uneven"] = _raises(lambda: shard_batch(dmesh, torch.stack([a.data] * (world - 1))))
    res["jax_loaded"] = _jax_loaded()
    return res


def levels_world(inp: dict) -> dict:
    """test_torch_shard_scheme.py (4 ranks): the rns multiply at k = 8 and
    at level 1 of k = 5, with keys switched inside and switched ahead; its
    ks_omega > 1 refusal."""
    res = {}
    for name, st in inp.items():
        fhe, pk, sk, rlk, (a, b) = _state(st, "cpu")
        mesh = M.make_mesh({"rns": dist.get_world_size()}, "cpu")
        out, res[f"{name}_counts"] = _counted(
            lambda: shard_scheme.multiply_relin_shardmap(fhe.ctx, a, b, rlk, mesh))
        res[name] = _ct(fhe, out, sk)
        res[f"{name}_single"] = _ct(fhe, bfv.multiply(fhe.ctx, a, b, rlk), sk)
        if a.level:
            keys = bfv.switch_relin_keys(fhe.ctx, rlk, a.level)
            res[f"{name}_at_level"] = _ct(fhe, shard_scheme.multiply_relin_shardmap(
                fhe.ctx, a, b, keys, mesh, keys_at_level=True), sk)
        else:
            omega2 = make_context(make_scheme_params(SecurityParams(**st["kw"], ks_omega=2)),
                                  device="cpu")
            res["omega"] = _raises(lambda: shard_scheme.multiply_relin_shardmap(
                omega2, a, b, rlk, mesh))
    res["jax_loaded"] = _jax_loaded()
    return res


def dist_world(inp: dict) -> dict:
    """test_torch_dist_ntt.py (2 or 4 ranks): the distributed polymul at
    each n of the inputs, the forward/inverse round trip; 4 ranks also the
    coefficient-sharded multiply and its level-0 check."""
    world = dist.get_world_size()
    mesh = M.make_mesh({"coeff": world}, "cpu")
    res = {}
    for n, (ps, x, y) in inp["polymul"].items():
        tb = tntt.build_tables(n, ps, "cpu")
        f = dntt.make_distributed_polymul(mesh, tb, n)
        got, res[f"polymul_counts_{n}"] = _counted(
            lambda: f(torch.from_numpy(x.astype(np.int32)), torch.from_numpy(y.astype(np.int32))))
        res[f"polymul_{n}"] = convert.to_numpy(got)
    n, ps, x = inp["roundtrip"]
    tb = tntt.build_tables(n, ps, "cpu")
    blocks = M.Sharding(mesh, (None, None, "coeff"))
    fwd = dntt.dist_ntt_forward(blocks.local(torch.from_numpy(x.astype(np.int32))), tb, n,
                                world, mesh)
    res["forward"] = convert.to_numpy(M.assemble(fwd, mesh, "coeff", dim=2))
    res["roundtrip"] = convert.to_numpy(M.assemble(
        dntt.dist_ntt_inverse(fwd, tb, n, world, mesh), mesh, "coeff", dim=2))
    if "coeff" in inp:
        fhe, pk, sk, rlk, (a, b) = _state(inp["coeff"], "cpu")
        out, res["coeff_counts"] = _counted(
            lambda: dntt.multiply_relin_coeff_sharded(fhe.ctx, a, b, rlk, mesh))
        res["coeff"] = _ct(fhe, out, sk)
        res["coeff_single"] = _ct(fhe, bfv.multiply(fhe.ctx, a, b, rlk), sk)
        res["coeff_level1"] = _raises(lambda: dntt.multiply_relin_coeff_sharded(
            fhe.ctx, fhe.mod_switch_to_next(a), fhe.mod_switch_to_next(b), rlk, mesh))
    res["jax_loaded"] = _jax_loaded()
    return res


def card_world(kw: dict) -> dict:
    """tests/test_torch_cuda.py: on the card, the rns multiply over the
    world and the coefficient-sharded one, each against the card's
    single-device multiply, and the kernels each rank launched."""
    from fhe_tpu_torch.ops import ntt_cuda
    world = dist.get_world_size()
    fhe = FHE(make_scheme_params(SecurityParams(**kw)), seed=5, device="cuda")
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    a, b = (fhe.encrypt(fhe.encode(v), pk) for v in ([4, 5, 6], [7, 8, 9]))
    want = bfv.multiply(fhe.ctx, a, b, rlk)
    mesh = M.make_mesh({"rns": world})
    ntt_cuda.tensor_product.launches = ntt_cuda.keyswitch_fused.launches = 0
    out = shard_scheme.multiply_relin_shardmap(fhe.ctx, a, b, rlk, mesh)
    res = dict(rns_equal=torch.equal(out.data, want.data),
               rns_decoded=[int(v) for v in fhe.decode(fhe.decrypt(out, sk))[:3]],
               tensor_product=ntt_cuda.tensor_product.launches,
               keyswitch_fused=ntt_cuda.keyswitch_fused.launches,
               backend=dist.get_backend(), device=str(out.data.device))
    cmesh = M.make_mesh({"coeff": world})
    out = dntt.multiply_relin_coeff_sharded(fhe.ctx, a, b, rlk, cmesh)
    res["coeff_equal"] = torch.equal(out.data, want.data)
    return res
