"""The ops at a level of the leveled BFV slice, held bit for bit against the JAX package.

At tests/test_leveled.py's configuration, n = 256, log_q = 150 (k = 5),
h = 32, which takes the n < 1024 branch of the multiply (B4 on q, B4's
Lift lane on the level's Bsk base, which is sm_mrq_fused and B4 there in
one launch, fast_floor_fused with B6):
multiply_no_relin, relinearize and multiply at levels 0, 1 and 2, the chain
multiply -> mod_switch_to_next -> multiply, the plain ops, multiply_batch
and the rotations at level 1, against fhe_tpu.scheme.bfv, jitted, on a
use_pallas=False context, with the keys and ciphertexts of
tests/test_torch_leveled.py's module state (the port's *_from_noise entry
points with numpy draws, carried to the JAX package as arrays).  Residues
are compared with tolerance 0; the noise budget, which the JAX package
carries in float32, to 1e-4 bits."""

import jax.numpy as jnp
import pytest

from fhe_tpu.scheme import types as jtypes

from fhe_tpu_torch import convert
from fhe_tpu_torch.scheme import bfv as tbfv

from test_torch_leveled import (J, N, PRODUCT, VALS, _dec, _jct,  # noqa: F401
                                assert_ct_equal, s, torch_equal)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_multiply_at_level_matches_jax(s, level):
    (a, b), (ja, jb) = s.levels[level], s.jlevels[level]
    m3, jm3 = tbfv.multiply_no_relin(s.tctx, a, b), J.multiply_no_relin(s.jctx, ja, jb)
    assert_ct_equal(m3, jm3)
    assert m3.data.shape == (5 - level, 3, N)
    relin = tbfv.relinearize(s.tctx, m3, s.rlk)
    assert_ct_equal(relin, J.relinearize(s.jctx, jm3, s.jrlk))
    prod = tbfv.multiply(s.tctx, a, b, s.rlk)
    assert_ct_equal(prod, J.multiply(s.jctx, ja, jb, s.jrlk))
    assert torch_equal(prod, relin)
    assert _dec(s, m3) == _dec(s, prod) == PRODUCT
    # keys switched beforehand give the same bits
    rlk_l = tbfv.switch_relin_keys(s.tctx, s.rlk, level)
    assert torch_equal(tbfv.multiply(s.tctx, a, b, rlk_l, keys_at_level=True), prod)


def test_depth_two_chain_matches_jax(s):
    """test_leveled's abc: (x*y) switched down, times z switched down."""
    x, y, z = (s.cts[c] for c in "xyz")
    jx, jy, jz = (_jct(c) for c in (x, y, z))
    xy = tbfv.mod_switch_to_next(s.tctx, tbfv.multiply(s.tctx, x, y, s.rlk))
    got = tbfv.multiply(s.tctx, xy, tbfv.mod_switch_to_next(s.tctx, z), s.rlk)
    jxy = J.mod_switch_to_next(s.jctx, J.multiply(s.jctx, jx, jy, s.jrlk))
    assert_ct_equal(got, J.multiply(s.jctx, jxy, J.mod_switch_to_next(s.jctx, jz),
                                    s.jrlk))
    assert got.level == 1 and _dec(s, got, 2) == [110, 273]


def test_plain_ops_at_level_one_match_jax(s):
    (a, _), (ja, _) = s.levels[1], s.jlevels[1]
    pt = s.fhe.encode([4, 4, 4])
    jpt = jtypes.Plaintext(data=jnp.asarray(convert.to_numpy(pt)))
    got = tbfv.multiply_plain(s.tctx, a, pt)
    assert_ct_equal(got, J.multiply_plain(s.jctx, ja, jpt))
    assert _dec(s, got, 3) == [20, 40, 60]
    got = tbfv.add_plain(s.tctx, a, pt)
    assert_ct_equal(got, J.add_plain(s.jctx, ja, jpt))
    assert _dec(s, got, 3) == [9, 14, 19]
    assert _dec(s, tbfv.sub_plain(s.tctx, a, pt), 3) == [1, 6, 11]
    # NTT-resident at level 1, with the level's operand
    op = tbfv.plain_ntt_operand(s.tctx, pt, 1)
    assert op.shape == (4, 1, N)
    res = tbfv.multiply_plain(s.tctx, tbfv.to_ntt(s.tctx, a), pt, op)
    assert torch_equal(tbfv.to_coeff(s.tctx, res), tbfv.multiply_plain(s.tctx, a, pt))


def test_multiply_batch_at_level_one_matches_jax(s):
    (a, b), (ja, jb) = s.levels[1], s.jlevels[1]
    got = tbfv.multiply_batch(s.tctx, [a, b, a], [b, b, a], s.rlk)
    want = J.multiply_batch(s.jctx, [ja, jb, ja], [jb, jb, ja], s.jrlk)
    for g, w in zip(got, want):
        assert_ct_equal(g, w)
    assert _dec(s, got[0]) == PRODUCT and _dec(s, got[2]) == [25, 100, 225, 400]
    assert torch_equal(got[1], tbfv.multiply(s.tctx, b, b, s.rlk))
    with pytest.raises(ValueError, match="one level"):
        tbfv.multiply_batch(s.tctx, [a, s.cts["b"]], [b, b], s.rlk)


def test_rotations_at_level_one_match_jax(s):
    (a, _), (ja, _) = s.levels[1], s.jlevels[1]
    got = tbfv.rotate_rows(s.tctx, a, 1, s.gk)
    assert_ct_equal(got, J.rotate_rows(s.jctx, ja, 1, s.jgk))
    assert _dec(s, got, 3) == [10, 15, 20]
    got = tbfv.rotate_columns(s.tctx, a, s.gk)
    assert_ct_equal(got, J.rotate_columns(s.jctx, ja, s.jgk))
    assert [int(v) for v in s.fhe.decode(tbfv.decrypt(s.tctx, got, s.sk))
            [N // 2:N // 2 + 4]] == VALS["a"]
    batch = tbfv.rotate_rows_batch(s.tctx, [a, a], 1, s.gk)
    assert all(torch_equal(c, tbfv.rotate_rows(s.tctx, a, 1, s.gk)) for c in batch)
