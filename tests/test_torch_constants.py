"""The port's host constants equal the JAX package's: primes, scheme plan,
NTT tables (q primes and the encoder's t), decryption and Δ constants, and
the multiply's level-0 context fields (Bsk tables, t-folded mul tables,
SmMRq / FastFloor / Shenoy-Kumaresan constants, relinearization digits).
Reference functions: fhe_tpu.params.make_scheme_params,
fhe_tpu.ops.ntt.build_tables, fhe_tpu.ops.ntt_pallas.build_mul_tables,
fhe_tpu.ops.rns.make_decrypt, fhe_tpu.scheme.context.make_context and
_level_host.  Integers, tolerance 0."""

import numpy as np
import pytest

from fhe_tpu import params as jparams
from fhe_tpu import primes as jprimes
from fhe_tpu.ops import ntt as jntt
from fhe_tpu.ops import ntt_pallas as jnpal
from fhe_tpu.ops import rns as jrns
from fhe_tpu.scheme import context as jcontext

from fhe_tpu_torch import params as tparams
from fhe_tpu_torch import primes as tprimes
from fhe_tpu_torch.ops import ntt as tntt
from fhe_tpu_torch.ops import rns as trns
from fhe_tpu_torch.scheme import context as tcontext


def _u32(x):
    """int32 tensor -> numpy uint32 with the same bits."""
    return x.numpy().view(np.uint32)


CASES = [(n, t, k) for n, t in ((256, 65537), (1024, 65537), (1024, 786433))
         for k in (2, 3)]


def _plans(n, t, k):
    kw = dict(poly_degree=n, log_q=30 * k, plain_modulus=t, lambda_=0,
              hamming_weight=16)
    return (jparams.make_scheme_params(jparams.SecurityParams(**kw)),
            tparams.make_scheme_params(tparams.SecurityParams(**kw)))


@pytest.mark.parametrize("n,t,k", CASES)
def test_scheme_plan_matches(n, t, k):
    jp, tp = _plans(n, t, k)
    for f in ("n", "t", "q_primes", "aux_primes", "m_sk", "gamma", "m_tilde"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert tp.q == jp.q and tp.delta == jp.delta and tp.k == k
    assert tp.modulus_chain() == jp.modulus_chain()


@pytest.mark.parametrize("n,t,k", CASES)
def test_ntt_tables_match(n, t, k):
    jp, _ = _plans(n, t, k)
    for moduli in (jp.q_primes, (t,)):
        want = jntt.build_tables(n, moduli)
        got = tntt.build_tables(n, moduli, "cpu")
        assert got.primes == tuple(moduli)
        for f in tntt.FIELDS:
            np.testing.assert_array_equal(
                _u32(getattr(got, f)), np.asarray(getattr(want, f)),
                err_msg=f)


@pytest.mark.parametrize("n,t,k", CASES)
def test_decrypt_and_delta_consts_match(n, t, k):
    jp, _ = _plans(n, t, k)
    want = jrns.make_decrypt(jp.q_primes, t, jp.gamma)
    got = trns.make_decrypt(jp.q_primes, t, jp.gamma, "cpu")
    for f in want._fields:
        g = getattr(got, f)
        g = _u32(g) if f in trns.ARRAY_FIELDS else np.uint32(g)
        np.testing.assert_array_equal(g, np.asarray(getattr(want, f)),
                                      err_msg=f)
    for g, w in zip(tcontext._level_host(jp.q_primes, t),
                    jcontext._level_host(jp.q_primes, t)[:2]):
        np.testing.assert_array_equal(g, w)


def _assert_consts_equal(got, want, name):
    """Every field of a JAX NamedTuple of constants (arrays, scalars or
    nested tuples) against the port's dataclass of the same field names."""
    for f in want._fields:
        g, w = getattr(got, f), getattr(want, f)
        if hasattr(w, "_fields"):
            _assert_consts_equal(g, w, f"{name}.{f}")
            continue
        g = _u32(g) if hasattr(g, "numpy") else np.uint32(g)
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"{name}.{f}")


@pytest.mark.parametrize("n,t,k", CASES)
def test_multiply_context_consts_match(n, t, k):
    jp, tp = _plans(n, t, k)
    jctx = jcontext.make_context(jp, use_pallas=False, use_mxu=False)
    tctx = tcontext.make_context(tp, device="cpu")
    kb = jctx.bsk_counts[0]
    assert len(tp.bsk_primes) == kb and tp.bsk_primes == jp.bsk_primes
    # the Bsk tables the t-folded ones are made from
    ntt_bsk = tntt.build_tables(n, tp.bsk_primes, "cpu")
    for f in tntt.FIELDS:
        np.testing.assert_array_equal(_u32(getattr(ntt_bsk, f)),
                                      np.asarray(getattr(jctx.ntt_bsk, f)),
                                      err_msg=f)
    # the port keeps compact twiddles: only the scalars carry the t fold,
    # and the twiddles are the q context's own tensors
    want_q, want_b = jnpal.build_mul_tables(n, jp.q_primes, jp.bsk_primes, t,
                                            k, kb)
    for got, want, base in zip(tctx.mul_tables, (want_q, want_b),
                               (tctx.ntt_q, ntt_bsk)):
        assert got.primes == base.primes
        for f in ("p", "mu", "n_inv", "n_inv_shoup"):
            np.testing.assert_array_equal(_u32(getattr(got, f)),
                                          np.asarray(getattr(want, f))[:, 0],
                                          err_msg=f)
        for f in ("psi_br", "psi_br_shoup", "ipsi_br", "ipsi_br_shoup"):
            assert np.array_equal(_u32(getattr(got, f)), _u32(getattr(base, f)))
    assert tctx.mul_tables[0].psi_br is tctx.ntt_q.psi_br
    _assert_consts_equal(tctx.smq, jctx.smq, "smq")
    _assert_consts_equal(tctx.floor_c, jctx.floor_c, "floor_c")
    _assert_consts_equal(tctx.sk_c, jctx.sk_c, "sk_c")
    np.testing.assert_array_equal(_u32(tctx.inv_qhat), np.asarray(jctx.inv_qhat))
    # the relinearization digits' Shoup companions, from the host builder
    np.testing.assert_array_equal(tcontext._level_host(jp.q_primes, t)[3],
                                  np.asarray(jctx.inv_qhat_shoup))


def test_number_theory_matches():
    for n in (256, 1024, 8192):
        ps = jprimes.find_ntt_primes(n, 4)
        assert tprimes.find_ntt_primes(n, 4) == ps
        for p in ps + [65537, 786433]:
            assert tprimes.negacyclic_psi(n, p) == jprimes.negacyclic_psi(n, p)
    for x in (0, 1, 2, 65537, 786433, (1 << 61) - 1, 1_000_000_007 * 3):
        assert tprimes.is_prime(x) == jprimes.is_prime(x)


LEVEL_CASES = [dict(poly_degree=256, log_q=150, hamming_weight=32),
               dict(poly_degree=1024, log_q=90, hamming_weight=16, lambda_=0),
               dict(poly_degree=256, log_q=120, hamming_weight=16, ks_omega=2)]


@pytest.mark.parametrize("kw", LEVEL_CASES, ids=["n256_k5", "n1024_k3", "k4_omega2"])
def test_level_consts_match(kw):
    """Every per-level field of the context against the JAX context's: the
    Bsk base sizes, the BEHZ constants, the relinearization digits, the
    decryption and Δ constants, the modulus-switch constants, the grouped
    gadget weights (bfv._grouped_digit_residues builds them per level from
    ks_group_conv_tables) and the row views of the t-folded tables
    (ntt_pallas.build_mul_tables(..., k - L, bsk_counts[L]))."""
    jp = jparams.make_scheme_params(jparams.SecurityParams(**kw))
    tp = tparams.make_scheme_params(tparams.SecurityParams(**kw))
    jctx = jcontext.make_context(jp, use_pallas=False, use_mxu=False)
    tctx = tcontext.make_context(tp, device="cpu")
    k, omega = jp.k, kw.get("ks_omega", 1)
    assert tctx.bsk_counts == jctx.bsk_counts
    assert len(tctx.mod_switch) == len(jctx.mod_switch) == k - 1
    for lv in range(k):
        chain = jp.q_primes[:k - lv]
        assert tcontext.level_aux_count(tp, lv) == jctx.bsk_counts[lv] - 1
        for name in ("smq", "floor", "sk", "dec"):
            got = getattr(tctx, f"{name}_levels")[lv]
            want = getattr(jctx, f"{name}_levels")[lv]
            if name == "dec":
                for f in want._fields:
                    g = getattr(got, f)
                    np.testing.assert_array_equal(
                        _u32(g) if f in trns.ARRAY_FIELDS else np.uint32(g),
                        np.asarray(getattr(want, f)), err_msg=f"dec.{f}")
            else:
                _assert_consts_equal(got, want, f"{name}_levels[{lv}]")
        np.testing.assert_array_equal(_u32(tctx.inv_qhat_levels[lv]),
                                      np.asarray(jctx.inv_qhat_levels[lv][0]))
        for g, w in zip(tctx.delta_levels[lv], jctx.delta_levels[lv]):
            np.testing.assert_array_equal(_u32(g), np.asarray(w))
        np.testing.assert_array_equal(_u32(tctx.ks_conv_levels[lv]),
                                      jcontext.ks_group_conv_tables(chain, omega))
        if lv < k - 1:
            _assert_consts_equal(tctx.mod_switch[lv], jctx.mod_switch[lv],
                                 f"mod_switch[{lv}]")
        want_q, want_b = jnpal.build_mul_tables(tp.n, jp.q_primes, jp.bsk_primes, jp.t,
                                                k - lv, jctx.bsk_counts[lv])
        for got, want in zip(tctx.mul_levels[lv], (want_q, want_b)):
            assert got.k == want.p.shape[0]
            for f in ("p", "mu", "n_inv", "n_inv_shoup"):
                np.testing.assert_array_equal(_u32(getattr(got, f)),
                                              np.asarray(getattr(want, f))[:, 0],
                                              err_msg=f"level {lv} {f}")
        # row views of level 0's tables, m_sk last
        tq0, tb0 = tctx.mul_levels[0]
        tq, tb = tctx.mul_levels[lv]
        assert tq.psi_br.data_ptr() == tq0.psi_br.data_ptr()
        assert tb.psi_br.data_ptr() == tb0.psi_br[tb0.k - tb.k].data_ptr()
        assert tb.primes[-1] == tp.m_sk and tq.primes == chain
    assert tctx.smq is tctx.smq_levels[0] and tctx.inv_qhat is tctx.inv_qhat_levels[0]
