"""The port's distributed coefficient-block NTT (fhe_tpu_torch.parallel.
distributed_ntt) held bit for bit against fhe_tpu.parallel.distributed_ntt.

Spawned gloo worlds of 2 and 4 CPU ranks (tests/torch_ranks.py), one per
size: the distributed polymul at n = 256 and 1024 (k = 2, two rows), the
forward transform and the forward/inverse round trip at n = 512, k = 3; the
world of 4 also the coefficient-sharded multiply + relinearize at n = 2048,
log_q = 90, lambda_ = 0, h = 16 from the JAX package's keys and
ciphertexts.  References: JAX's make_distributed_polymul and
multiply_relin_coeff_sharded on conftest's virtual devices, and its
single-device forward NTT, jitted.  Tolerance 0 (the noise budget to 1e-4
bits of JAX's float32 value).  Mirrors tests/test_parallel.py:31-67 and
:168-189 (n = 32768 over 8 ranks runs on the card: chip_smoke.py).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from fhe_tpu import primes
from fhe_tpu.ops import ntt as jntt
from fhe_tpu.parallel import distributed_ntt as jdntt
from fhe_tpu.parallel import mesh as jmesh

from fhe_tpu_torch.parallel import launch

import torch_ranks
from test_torch_parallel import assert_ct, jax_state

WORLDS = (2, 4)
POLY_N = (256, 1024)
KW = dict(poly_degree=2048, log_q=90, lambda_=0, hamming_weight=16)
RNG = np.random.default_rng(5)


def _random(ps, rows, n):
    return np.stack([RNG.integers(0, p, (rows, n), dtype=np.uint32) for p in ps])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    poly = {}
    for n in POLY_N:
        ps = primes.find_ntt_primes(n, 2)
        poly[n] = (ps, _random(ps, 2, n), _random(ps, 2, n))
    ps3 = primes.find_ntt_primes(512, 3)
    inp = dict(polymul=poly, roundtrip=(512, ps3, _random(ps3, 1, 512)))
    jfhe, rlk, (ct1, ct2), inp_c = jax_state(KW, seed=11)
    worlds = {w: launch.start(torch_ranks.dist_world, w, "gloo",
                              args=(dict(inp, coeff=inp_c) if w == 4 else inp,),
                              workdir=tmp_path_factory.mktemp(f"world{w}"))
              for w in WORLDS}
    try:
        ref = {}
        for w in WORLDS:
            mesh = jmesh.make_mesh({"coeff": w}, jax.devices()[:w])
            for n, (ps, x, y) in poly.items():
                f = jdntt.make_distributed_polymul(mesh, jntt.build_tables(n, ps), n)
                ref[w, n] = np.asarray(f(jnp.asarray(x), jnp.asarray(y)))
        ref["forward"] = np.asarray(jax.jit(jntt.ntt_forward)(
            jnp.asarray(inp["roundtrip"][2]), jntt.build_tables(512, ps3)))
        ref["coeff"] = jdntt.multiply_relin_coeff_sharded(
            jfhe.ctx, ct1, ct2, rlk, jmesh.make_mesh({"coeff": 4}, jax.devices()[:4]))
        got = {w: world.wait(timeout=120) for w, world in worlds.items()}
    finally:
        for world in worlds.values():
            world.kill()
    return ref, got, inp


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("n", POLY_N)
def test_distributed_polymul_matches_jax(runs, world, n):
    """Each rank's assembled product equals JAX's distributed polymul, with
    log2(P) exchanges per transform (two forward, one inverse)."""
    ref, got, _ = runs
    for res in got[world]:
        np.testing.assert_array_equal(res[f"polymul_{n}"], ref[world, n])
        assert res[f"polymul_counts_{n}"] == {
            "all_gather": 0, "assemble": 1, "exchange": 3 * (world.bit_length() - 1), "psum": 0}


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_forward_and_roundtrip(runs, world):
    """The assembled forward equals JAX's single-device forward NTT; the
    inverse of it gives the input back."""
    ref, got, inp = runs
    for res in got[world]:
        np.testing.assert_array_equal(res["forward"], ref["forward"])
        np.testing.assert_array_equal(res["roundtrip"], inp["roundtrip"][2])


def test_multiply_relin_coeff_sharded_matches_jax(runs):
    """n = 2048 over 4 ranks: JAX's coefficient-sharded multiply on every
    rank, equal to the port's single-device multiply, decoding
    [28, 40, 54]; only exchanges (six transforms of 2 stages) and the
    result's assembly; a level-1 input raises."""
    ref, got, _ = runs
    for res in got[4]:
        assert_ct(res["coeff"], ref["coeff"])
        np.testing.assert_array_equal(res["coeff"]["data"], res["coeff_single"]["data"])
        assert res["coeff"]["decoded"] == [28, 40, 54]
        assert res["coeff_counts"] == {"all_gather": 0, "assemble": 1, "exchange": 12,
                                       "psum": 0}
        assert "level 0" in res["coeff_level1"]


def test_ranks_load_no_jax(runs):
    _, got, _ = runs
    assert all(res["jax_loaded"] == [] for w in WORLDS for res in got[w])
