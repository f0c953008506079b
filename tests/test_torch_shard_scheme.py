"""The port's rns-sharded multiply at k = 8 and at a level below the top,
held bit for bit against fhe_tpu.parallel.shard_scheme.

One spawned gloo world of 4 CPU ranks (tests/torch_ranks.py) runs
multiply_relin_shardmap at k = 8 (two primes per rank, Bsk rows padded)
and at level 1 of k = 5 (four primes left, one per rank; level-0 keys
switched down inside, and keys switched ahead with keys_at_level), from
the JAX package's keys and ciphertexts at n = 128, h = 16; the references
are JAX's multiply_relin_shardmap, jitted in this process on conftest's
virtual devices (at level 1 with the keys of JAX's switch_relin_keys and
keys_at_level=True).  Residues with tolerance 0, the noise budget to 1e-4 bits
of JAX's float32 value (tests/test_shard_scheme.py:43-76; the k = 4 cases:
tests/test_torch_parallel.py).
"""

import numpy as np
import pytest
import jax

from fhe_tpu.parallel import mesh as jmesh
from fhe_tpu.parallel import shard_scheme as jss
from fhe_tpu.scheme import bfv as jbfv

from fhe_tpu_torch.parallel import launch

import torch_ranks
from test_torch_parallel import assert_ct, ct_inputs, jax_state

KW8 = dict(poly_degree=128, log_q=240, hamming_weight=16)     # k = 8
KW5 = dict(poly_degree=128, log_q=150, hamming_weight=16)     # k = 5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    f8, rlk8, cts8, inp8 = jax_state(KW8)
    f5, rlk5, cts5, inp5 = jax_state(KW5)
    cts5 = [f5.mod_switch_to_next(c) for c in cts5]
    inp5["cts"] = ct_inputs(cts5)
    assert (f8.params.k, f5.params.k, cts5[0].level) == (8, 5, 1)
    world = launch.start(torch_ranks.levels_world, 4, "gloo", args=({"k8": inp8, "k5": inp5},),
                         workdir=tmp_path_factory.mktemp("world4"))
    try:
        mesh = jmesh.make_mesh({"rns": 4}, jax.devices()[:4])
        # the level's keys from JAX's jitted switch_relin_keys: JAX's
        # multiply_relin_shardmap switches level-0 keys down eagerly, which
        # takes minutes here; keys_at_level=True gives the same function
        rlk5_1 = jax.jit(jbfv.switch_relin_keys, static_argnums=(2, 3))(f5.ctx, rlk5, 1, False)
        ref = {"k8": jss.multiply_relin_shardmap(f8.ctx, *cts8, rlk8, mesh),
               "k5": jss.multiply_relin_shardmap(f5.ctx, *cts5, rlk5_1, mesh,
                                                 keys_at_level=True)}
        got = world.wait(timeout=120)
    finally:
        world.kill()
    return ref, got


@pytest.mark.parametrize("name", ["k8", "k5"])
def test_multiply_relin_shardmap_matches_jax(runs, name):
    """k = 8 over 4 ranks and level 1 of k = 5 over 4: JAX's result on
    every rank, equal to the port's single-device multiply, decoding
    [28, 40, 54]; four all-gathers and the result's."""
    ref, got = runs
    for res in got:
        assert_ct(res[name], ref[name])
        np.testing.assert_array_equal(res[name]["data"], res[f"{name}_single"]["data"])
        assert res[name]["budget"] == res[f"{name}_single"]["budget"]
        assert res[name]["decoded"] == [28, 40, 54]
        assert res[f"{name}_counts"] == {"all_gather": 4, "assemble": 1, "exchange": 0,
                                         "psum": 0}


def test_leveled_keys_at_level(runs):
    """Keys switched to level 1 ahead (switch_relin_keys) and passed with
    keys_at_level give the same result as level-0 keys switched inside."""
    ref, got = runs
    for res in got:
        assert res["k5"]["level"] == 1
        assert_ct(res["k5_at_level"], ref["k5"])


def test_rejects_grouped_gadget_keys(runs):
    _, got = runs
    for res in got:
        assert "ks_omega > 1" in res["omega"]
        assert res["jax_loaded"] == []
