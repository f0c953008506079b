"""The port's rns-sharded multiply (fhe_tpu_torch.parallel: mesh,
shard_scheme, sharded) held bit for bit against fhe_tpu.parallel.

The JAX references run jitted in this process on conftest's virtual
8-device CPU mesh; the port runs in spawned gloo worlds of 2, 3 and 4 CPU
ranks (tests/torch_ranks.py, torch and fhe_tpu_torch only), one world per
size, all started before the references are computed.  Inputs: the JAX
package's keys and ciphertexts at n = 128, k = 4, h = 16, carried across as
numpy.  Residues are compared with tolerance 0; the noise budget equals
the port's single-device multiply's exactly and the JAX package's float32
value to 1e-4 bits.  Mirrors tests/test_shard_scheme.py:43-175 and
tests/test_parallel.py:94-157 (k = 8 and the leveled case:
tests/test_torch_shard_scheme.py).
"""

import numpy as np
import pytest
import jax

from fhe_tpu import FHE as JFHE
from fhe_tpu.params import SecurityParams as JSecurity
from fhe_tpu.params import make_scheme_params as jmake_params
from fhe_tpu.parallel import mesh as jmesh
from fhe_tpu.parallel import shard_scheme as jss

from fhe_tpu_torch.parallel import launch

import torch_ranks

KW = dict(poly_degree=128, log_q=120, hamming_weight=16)      # k = 4
KW3 = dict(poly_degree=128, log_q=90, hamming_weight=16)      # k = 3
WORLDS = (2, 3, 4)
RNG = np.random.default_rng(128)


def ct_inputs(cts) -> list:
    return [dict(data=np.asarray(c.data), level=int(c.level), ntt=bool(c.is_ntt_form),
                 budget=float(c.noise_budget)) for c in cts]


def jax_state(kw, seed=7):
    """JAX keys and two ciphertexts of [4,5,6] and [7,8,9], and the same as
    numpy inputs for the ranks."""
    fhe = JFHE(jmake_params(JSecurity(**kw)), seed=seed)
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    cts = [fhe.encrypt(fhe.encode(v), pk) for v in ([4, 5, 6], [7, 8, 9])]
    inp = dict(kw=kw, pk=np.asarray(pk.data), sk=np.asarray(sk.data),
               rlk=np.asarray(rlk.data), cts=ct_inputs(cts))
    return fhe, rlk, cts, inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    jfhe, rlk, (ct1, ct2), inp = jax_state(KW)
    k = jfhe.params.k
    assert k == 4
    inp.update(kw3=KW3, poly=np.stack([RNG.integers(0, p, 128, dtype=np.uint32)
                                       for p in jfhe.params.q_primes]))
    worlds = {w: launch.start(torch_ranks.parallel_world, w, "gloo", args=(inp,),
                              workdir=tmp_path_factory.mktemp(f"world{w}"))
              for w in WORLDS}
    try:
        ref = {}
        for p_devs in (2, 4):
            mesh = jmesh.make_mesh({"rns": p_devs}, jax.devices()[:p_devs])
            ref[p_devs] = jss.multiply_relin_shardmap(jfhe.ctx, ct1, ct2, rlk, mesh)
        ref["psum"] = jss.keyswitch_delta_psum(jfhe.ctx, jax.numpy.asarray(inp["poly"]), rlk.data,
                                               mesh)
        got = {w: world.wait(timeout=120) for w, world in worlds.items()}
    finally:
        for world in worlds.values():
            world.kill()
    return ref, got


def assert_ct(got, want):
    np.testing.assert_array_equal(got["data"], np.asarray(want.data).astype(np.uint32))
    assert got["level"] == want.level and got["ntt"] == bool(want.is_ntt_form)
    assert abs(got["budget"] - float(want.noise_budget)) < 1e-4


@pytest.mark.parametrize("p_devs", [2, 4])
def test_multiply_relin_shardmap_matches_jax(runs, p_devs):
    """k = 4 over 2 ranks (two primes per rank) and over 4 (one prime per
    rank): every rank returns JAX's multiply_relin_shardmap result, equal
    to the port's single-device multiply and decoding [28, 40, 54]."""
    ref, got = runs
    for res in got[p_devs]:
        assert_ct(res["shardmap"], ref[p_devs])
        np.testing.assert_array_equal(res["shardmap"]["data"], res["single"]["data"])
        assert res["shardmap"]["budget"] == res["single"]["budget"]
        assert res["shardmap"]["decoded"] == [28, 40, 54]


def test_shardmap_rejects_uneven_k_and_level_mismatch(runs):
    _, got = runs
    for res in got[2]:
        assert "% P == 0" in res["uneven"]
    for w in (2, 4):
        for res in got[w]:
            assert "share a level" in res["level_mismatch"]


def test_sharded_fhe_routes_explicit_path(runs):
    """ShardedFHE.multiply takes the explicit path where the prime count
    divides the axis (k = 4 over 4 ranks, timed as "multiply_shardmap") and
    the wrapped multiply where it does not (k = 4 over 3 ranks: no
    collective at all); both equal JAX's result."""
    ref, got = runs
    for res in got[4]:
        assert_ct(res["sharded"], ref[4])
        assert res["sharded_monitor"] == 1
        assert res["sharded_counts"]["all_gather"] == 4
    for res in got[3]:
        np.testing.assert_array_equal(res["routed"]["data"],
                                      np.asarray(ref[4].data).astype(np.uint32))
        assert res["routed"]["decoded"] == [28, 40, 54]
        assert res["routed_monitor"] == 0
        assert not any(res["routed_counts"].values()), res["routed_counts"]


def test_shard_containers_keep_the_digit_axis(runs):
    """shard() on a dict holding a tuple: the same objects as sharding each
    directly; key material splits its prime axis 1 (two digits of four
    primes split over 4 ranks), other objects their axis 0 (which raises
    for the same two rows)."""
    _, got = runs
    for res in got[4]:
        assert res["bundle_same"]
        assert res["digit_axis"] is None
        assert "does not split" in res["prime_axis"]


def test_keyswitch_psum_matches_jax(runs):
    ref, got = runs
    for res in got[4]:
        np.testing.assert_array_equal(res["psum_delta"], np.asarray(ref["psum"]).astype(np.uint32))
        np.testing.assert_array_equal(res["psum_delta"], res["psum_single"])


def test_psum_mod_exact_at_p_minus_1(runs):
    """Every rank holds p - 1: the 16-bit-split all-reduce returns
    4 (p - 1) mod p exactly (tests/test_shard_scheme.py:161-180)."""
    _, got = runs
    p = torch_ranks.PSUM_PRIME
    for res in got[4]:
        assert (res["psum_mod"] == (4 * (p - 1)) % p).all()


@pytest.mark.parametrize("p_devs", [2, 4])
def test_collective_inventory(runs, p_devs):
    """The multiply makes all-gathers only: the four exchanges of the
    module docstring and the one that assembles the result, no all-reduce
    and no pairwise exchange; the psum key switch makes its two
    all-reduces and no gather of the digits."""
    _, got = runs
    for res in got[p_devs]:
        assert res["counts"] == {"all_gather": 4, "assemble": 1, "exchange": 0, "psum": 0}
        if p_devs == 4:
            assert res["psum_counts"] == {"all_gather": 0, "assemble": 1, "exchange": 0,
                                          "psum": 2}


def test_dp_layout(runs):
    """The dp layout over 4 ranks: shard_batch of a [4, k, 2, n] stack,
    each rank's multiply_batch of its ciphertext, and add, assembled; every
    element equals JAX's multiply and decodes (tests/test_parallel.py:94-114,
    __graft_entry__.py:119-146).  A stack of 3 does not split."""
    ref, got = runs
    for res in got[4]:
        assert len(res["dp_mul"]) == 4
        for ct in res["dp_mul"]:
            np.testing.assert_array_equal(ct["data"], np.asarray(ref[4].data).astype(np.uint32))
            assert ct["decoded"] == [28, 40, 54]
        assert res["dp_add"] == [[8, 10, 12]] * 4
        assert "does not split" in res["dp_uneven"]


def test_mesh_checks_world_size_and_device(runs):
    """make_mesh raises for a mesh larger or smaller than the world, and its
    default device is the card, which raises here."""
    _, got = runs
    for res in got[4]:
        assert "mesh needs 3 ranks, the process group has 4" in res["mesh_size"]
        assert res["mesh_default"] is None or "cuda" in res["mesh_default"]


def test_distributed_ntt_rejects_non_power_of_two(runs):
    _, got = runs
    for res in got[3]:
        assert "power of two" in res["coeff_3"]


def test_ranks_load_no_jax(runs):
    _, got = runs
    assert all(res["jax_loaded"] == [] for w in WORLDS for res in got[w])
