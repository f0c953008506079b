"""BGV's plain ops, switched keys and rotations, held bit for bit against
fhe_tpu.scheme.bgv, on tests/test_torch_bgv.py's module state (n = 256,
log_q = 120, k = 4, h = 32; keys and ciphertexts of both packages from the
same JAX draws): add_plain, sub_plain and multiply_plain at scale_t 1 and
at scale_t != 1 (coefficient and NTT form), the relinearization and Galois
keys switched down t-corrected to levels 1 and 2, rotate_rows,
rotate_columns and the hoisted calls (apply_galois_hoisted, its _sum and
_batch forms) at level 1.  Residues and scale_t are compared with
tolerance 0; the noise budget, which the JAX package carries in float32,
to 1e-4 bits."""

import numpy as np
import pytest
import torch

from fhe_tpu_torch import convert
from fhe_tpu_torch.scheme import bfv as tbfv
from fhe_tpu_torch.scheme import bgv as tbgv

from test_torch_bgv import (ELEMENTS, HOIST, J, N, PRODUCT, VALS, _dec,  # noqa: F401
                            _jpt, _np, _rotated, _switched, assert_ct_equal, b)


@pytest.mark.parametrize("level", [0, 1])
def test_plain_ops_match_jax(b, level):
    """scale_t = 1 at level 0; at level 1 scale_t = q_last mod t, so the
    plain operand of add_plain / sub_plain is divided by it first."""
    (ja, _), (ta, _) = _switched(b, level)
    assert (ta.scale_t == 1) == (level == 0)
    pt = b.tenc.encode([2, 2, 2, 2])
    jpt = _jpt(pt)
    for jf, tf, want in ((J.add_plain, tbgv.add_plain, [7, 12, 17, 22]),
                         (J.sub_plain, tbgv.sub_plain, [3, 8, 13, 18]),
                         (J.multiply_plain, tbgv.multiply_plain, [10, 20, 30, 40])):
        got = tf(b.tctx, ta, pt)
        assert_ct_equal(got, jf(b.jctx, ja, jpt))
        assert _dec(b, got) == want
    # NTT-resident: the operand is transformed instead
    jn, tn = J.to_ntt(b.jctx, ja), tbgv.to_ntt(b.tctx, ta)
    got = tbgv.add_plain(b.tctx, tn, pt)
    assert_ct_equal(got, J.add_plain(b.jctx, jn, jpt))
    assert _dec(b, got) == [7, 12, 17, 22]


@pytest.mark.parametrize("level", [1, 2])
def test_switched_keys_match_jax(b, level):
    got = tbgv.switch_relin_keys(b.tctx, b.trlk, level)
    np.testing.assert_array_equal(convert.to_numpy(got),
                                  _np(J.switch_relin_keys(b.jctx, b.jrlk, level).data))
    gal = tbgv.switch_galois_keys(b.tctx, b.tgk, level)
    jgal = J.switch_galois_keys(b.jctx, b.jgk, level)
    for g in ELEMENTS:
        np.testing.assert_array_equal(convert.to_numpy(gal.data[g]), _np(jgal.data[g]))
    # BFV's rounding switch gives other keys, with which the product decodes
    # wrong
    bfv_keys = tbfv.switch_relin_keys(b.tctx, b.trlk, level)
    assert not torch.equal(bfv_keys.data, got.data)
    _, (ta, tb_) = _switched(b, level)
    assert _dec(b, tbgv.multiply(b.tctx, ta, tb_, got, keys_at_level=True)) == PRODUCT
    assert _dec(b, tbgv.multiply(b.tctx, ta, tb_, bfv_keys, keys_at_level=True)) != PRODUCT


# ---------------------------------------------------------------------------
# rotations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("level,steps", [(0, 1), (0, 3), (1, 1)])
def test_rotate_rows_matches_jax(b, level, steps):
    (ja, _), (ta, _) = _switched(b, level)
    got = tbgv.rotate_rows(b.tctx, ta, steps, b.tgk)
    assert_ct_equal(got, J.rotate_rows(b.jctx, ja, steps, b.jgk))
    assert _dec(b, got, N // 2) == _rotated(VALS[0], steps)


def test_rotate_columns_matches_jax(b):
    (ja, jb), (ta, tb_) = _switched(b, 1)
    got = tbgv.rotate_columns(b.tctx, ta, b.tgk)
    assert_ct_equal(got, J.rotate_columns(b.jctx, ja, b.jgk))
    dec = _dec(b, got, N)
    assert dec[N // 2:N // 2 + 4] == VALS[0] and dec[:4] == [0] * 4


def test_hoisted_match_jax(b):
    """At level 1: the keys switched down t-corrected, scale_t != 1."""
    (ja, jb), (ta, tb_) = _switched(b, 1)
    got = tbgv.apply_galois_hoisted(b.tctx, ta, HOIST, b.tgk)
    for s, (gi, wi) in enumerate(zip(got, J.apply_galois_hoisted(b.jctx, ja, HOIST,
                                                                 b.jgk)), 1):
        assert_ct_equal(gi, wi)
        assert _dec(b, gi, N // 2) == _rotated(VALS[0], s)
    acc = tbgv.apply_galois_hoisted_sum(b.tctx, ta, HOIST, b.tgk)
    assert_ct_equal(acc, J.apply_galois_hoisted_sum(b.jctx, ja, HOIST, b.jgk))
    assert _dec(b, acc, 2) == [5 + 10 + 15, 10 + 15 + 20]
    rows = tbgv.apply_galois_hoisted_batch(b.tctx, [ta, tb_], HOIST, b.tgk)
    wrows = J.apply_galois_hoisted_batch(b.jctx, [ja, jb], HOIST, b.jgk)
    for row, wrow in zip(rows, wrows):
        for gi, wi in zip(row, wrow):
            assert_ct_equal(gi, wi)
